"""The port's whole control loop against the JAX package: the committed
golden traces replayed through the port's ``control_trace``, and the
port's ``make_fused_loop`` against the JAX ``make_fused_loop`` on the same
fleet (carried across with ``convert.from_reference``)."""

from __future__ import annotations

import json
import pathlib
import sys

import numpy as np
import pytest
import torch

import repro.core.controller as jctl
from repro.api.session import ScenarioRunner as JaxRunner
from repro.streaming.scenarios import scenario_matrix
from repro_torch.convert import from_reference, scenario_from_reference
from repro_torch.core import controller as tctl
from repro_torch.streaming.scenarios import control_trace

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
sys.path.insert(0, str(GOLDEN))
import regen as _regen  # noqa: E402

ENTRIES = {name: (s, tick) for name, s, _proactive, tick in _regen.entries()}


@pytest.mark.parametrize("fused_decide", [False, True])
@pytest.mark.parametrize("name", ["vld_fused", "soak"])
def test_golden_trace_replays_through_the_port(name, fused_decide):
    """The two goldens the fused loop can run (static budgets), in float64
    on the CPU, with the fused decide off and on: the decision surface is
    exact and the run metrics match to rel 1e-6."""
    scenario, tick = ENTRIES[name]
    want = json.loads((GOLDEN / f"{name}_control_trace.json").read_text())["scenarios"][name]
    got = control_trace(
        [scenario_from_reference(scenario)], tick_interval=tick,
        fused_decide=fused_decide, device="cpu", dtype=torch.float64,
    )["scenarios"][name]
    for key in ("actions", "allocations", "provisioned_total", "optimal_total"):
        assert got[key] == want[key], key
    for key in ("k_total", "miss", "warm"):
        assert got["trajectory"][key] == want["trajectory"][key], key
    for metric in ("drop_rate", "mean_sojourn", "deadline_miss_rate"):
        assert got[metric] == pytest.approx(want[metric], rel=1e-6, abs=1e-9), metric


def test_fused_loop_matches_jax_fused_loop_float32():
    """An 8-scenario matrix through both packages' fused loops in float32
    (JAX's default precision): codes and allocations exact, every float
    output within rtol 1e-6 (NaN where the reference has NaN) -- the
    routing product and the traffic solve round differently in XLA and
    PyTorch (test_torch_modules), which this fleet keeps below 1e-6."""
    scens = [s.with_(negotiated=False)
             for s in scenario_matrix(8, seed=31, horizon=20.0, warmup=5.0, dt=0.05)]
    runner = JaxRunner(scens, tick_interval=5.0, backend="numpy", fused=False)
    params = runner._params()
    loop_j, n_ticks = jctl.make_fused_loop(runner.arrays, runner.static, params,
                                           steps_per_tick=runner._steps_per_tick)
    want = {k: np.asarray(v) for k, v in loop_j(runner.k).items()}
    arrays, static, pr, state = from_reference(
        runner.arrays, runner.static, params, runner.k, device="cpu", dtype=torch.float32
    )
    loop_t, n_ticks_t = tctl.make_fused_loop(arrays, static, pr,
                                             steps_per_tick=runner._steps_per_tick,
                                             device="cpu", dtype=torch.float32)
    assert n_ticks_t == n_ticks
    # Two chunks: resuming from the returned state continues the same run.
    state, first = loop_t.run(state, 2)
    state, rest = loop_t.run(state)
    got = {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
           for k, v in rest.items()}
    for key in ("codes", "k", "sojourn", "et_cur", "et_target", "applied"):
        got[key] = np.concatenate([first[key].numpy(), got[key]])
    got["miss"] = got["miss"] + first["miss"].numpy()
    got["warm_windows"] = got["warm_windows"] + first["warm_windows"]
    assert set(got) == set(want)
    for key in ("codes", "k", "applied", "k_final", "miss", "warm_windows"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("sojourn", "et_cur", "et_target", "q_final", "offered", "served",
                "dropped", "ext_admitted", "ext_offered", "q_int", "q_max"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-6,
                                   equal_nan=True, err_msg=key)
    assert len(set(got["codes"].ravel().tolist())) >= 2
