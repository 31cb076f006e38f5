"""The port's window-at-a-time control loop against the JAX package: the
float64 twin (``BatchQueueSim(backend="numpy")`` + ``tick_batch``) replays
the four non-proactive goldens (all five, compacted too, in
``test_torch_compaction.py``) and the negotiated scenario matrix bit for
bit; ``tick_batch`` on a converted ``MeasurementBatch`` gives the
reference's rows; the torch window of ``BatchQueueSim`` matches the JAX
window to 2e-6 in float32 and the window kernel's order bitwise; the
batched E[T] and traffic solve match the reference's numpy backend
bitwise, their torch backend within 1e-12 in float64."""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

import repro.core.batched as jb
import repro.core.controller as jctl
import repro.streaming.batchsim as jbs
from repro.api.session import ScenarioRunner as JaxRunner
from repro.streaming import scenarios as jsc
from repro_torch.api.graph import GraphValidationError
from repro_torch.api.session import ScenarioRunner
from repro_torch.convert import (measurement_from_reference, params_from_reference,
                                 scenario_from_reference, static_from_reference)
from repro_torch.core import batched as tb, controller as tctl
from repro_torch.kernels import LAUNCHES
from repro_torch.streaming import batchsim as tbs, scenarios as tsc

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
sys.path.insert(0, str(GOLDEN))
import regen as _regen  # noqa: E402
from test_torch_window import np_window  # noqa: E402  (the window kernel's order)

ENTRIES = {name: (s, tick) for name, s, _proactive, tick in _regen.entries()}
F32 = np.float32


def _port_arrays(a) -> tbs.BatchArrays:
    return tbs.BatchArrays(**{f.name: getattr(a, f.name)
                              for f in dataclasses.fields(tbs.BatchArrays)})


def _same(x, y) -> bool:
    """Equal, NaN with NaN, through nested lists / dicts / tuples."""
    if isinstance(x, dict):
        return isinstance(y, dict) and x.keys() == y.keys() and all(_same(x[k], y[k]) for k in x)
    if isinstance(x, (list, tuple)):
        return len(x) == len(y) and all(_same(a, b) for a, b in zip(x, y))
    if isinstance(x, np.ndarray):
        return np.array_equal(x, np.asarray(y), equal_nan=x.dtype.kind == "f")
    if isinstance(x, float) and isinstance(y, float) and np.isnan(x):
        return np.isnan(y)
    return x == y


# --------------------------------------------------------------------------- #
# the float64 twin end to end
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["vld", "fpd", "vld_fused", "soak"])
def test_golden_trace_replays_through_the_port_twin(name):
    """Every non-proactive golden through the port's ``control_trace(...,
    backend="numpy")``: the whole trace equals the reference twin's, and
    the committed fixture's decision surface and rounded metrics exactly
    (``vld`` and ``fpd`` are negotiated: leases between windows)."""
    from repro.streaming.scenarios import control_trace as jax_trace

    scenario, tick = ENTRIES[name]
    want = json.loads((GOLDEN / f"{name}_control_trace.json").read_text())["scenarios"][name]
    ref = jax_trace([scenario], tick_interval=tick)["scenarios"][name]
    got = tsc.control_trace([scenario_from_reference(scenario)], tick_interval=tick,
                            backend="numpy")["scenarios"][name]
    assert got == ref
    assert got == want


def _zoo(n=32, seed=0, **kw):
    ref = jsc.scenario_matrix(n, seed=seed, **kw)
    return ref, [scenario_from_reference(s) for s in ref]


def test_negotiated_zoo_runs_the_reference_twin_bitwise():
    """``scenario_matrix(32, seed=0)`` as generated (8 negotiated lanes)
    through both twins: reports, decisions (action, allocation, lease,
    E[T], reason) and trajectories bitwise."""
    ref, port = _zoo()
    assert sum(s.negotiated for s in port) == 8
    jr = JaxRunner(ref, backend="numpy")
    tr = ScenarioRunner(port, backend="numpy")
    assert not jr.fused and not tr.fused
    before = dict(LAUNCHES)
    want, got = jr.run(), tr.run()
    assert dict(LAUNCHES) == before  # the host twin launches nothing
    for w, g in zip(want, got):
        assert _same(dataclasses.asdict(g), dataclasses.asdict(w)), w.name
    actions = {a for r in got for a in r.actions}
    assert {"rebalance", "scale_out", "scale_in", "infeasible"} <= actions
    for dj, dt in zip(jr.decisions, tr.decisions):
        assert len(dj) == len(dt)
        for x, y in zip(dj, dt):
            assert _same(dataclasses.asdict(y), dataclasses.asdict(x))


def test_window_loop_takes_one_window_per_tick_on_the_torch_backend(monkeypatch):
    """``backend="torch"`` on the CPU: negotiated scenarios take the
    window-at-a-time loop, one ``window_step_fn`` call per tick."""
    from repro_torch.kernels.queue_step import ref as qref

    calls = []
    real = qref.queue_window

    def counting(*args):
        calls.append(args[2].shape[0])
        return real(*args)

    monkeypatch.setattr(qref, "queue_window", counting)
    _ref, port = _zoo(8, seed=2, horizon=20.0, warmup=5.0)
    runner = ScenarioRunner(port, tick_interval=5.0, device="cpu")
    assert not runner.fused and runner.sim.backend == "torch"
    reports = runner.run()
    assert calls == [100, 100, 100, 100]
    assert all(len(r.actions) == 4 for r in reports)


@pytest.mark.parametrize("name", ["vld", "fpd"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_negotiated_goldens_replay_through_the_torch_window(name, dtype):
    """The negotiated goldens through the torch window on the CPU (the
    window kernel's plain version), float64 and float32: the decision
    surface equals the fixture; float32 metrics within 1e-5."""
    scenario, tick = ENTRIES[name]
    want = json.loads((GOLDEN / f"{name}_control_trace.json").read_text())["scenarios"][name]
    got = tsc.control_trace([scenario_from_reference(scenario)], tick_interval=tick,
                            device="cpu", dtype=dtype)["scenarios"][name]
    for key in ("actions", "allocations", "provisioned_total", "optimal_total"):
        assert got[key] == want[key], key
    assert got["trajectory"] == want["trajectory"]
    for metric in ("drop_rate", "mean_sojourn", "deadline_miss_rate"):
        assert got[metric] == pytest.approx(want[metric], rel=1e-5, abs=1e-9), metric


def test_runner_gate_follows_the_reference():
    _ref, port = _zoo(8, seed=2, horizon=20.0, warmup=5.0)
    static = [s.with_(negotiated=False) for s in port]
    assert ScenarioRunner(static, tick_interval=5.0, device="cpu").fused
    assert not ScenarioRunner(static, tick_interval=5.0, device="cpu", fused=False).fused
    assert not ScenarioRunner(port, tick_interval=5.0, device="cpu").fused
    assert not ScenarioRunner(static, tick_interval=5.0, backend="numpy").fused
    assert not ScenarioRunner(static, tick_interval=5.0, device="cpu", controlled=False).fused
    with pytest.raises(GraphValidationError, match="backend='torch'"):
        ScenarioRunner(static, tick_interval=5.0, backend="numpy", fused=True)
    with pytest.raises(ValueError, match="unknown backend"):
        ScenarioRunner(static, backend="jax")


def test_uncontrolled_sweep_freezes_the_allocation():
    ref, port = _zoo(6, seed=4, horizon=20.0, warmup=5.0)
    jr = JaxRunner(ref, tick_interval=5.0, backend="numpy", controlled=False)
    tr = ScenarioRunner(port, tick_interval=5.0, backend="numpy", controlled=False)
    want, got = jr.run(), tr.run()
    np.testing.assert_array_equal(tr.k, tr.k0)
    for w, g in zip(want, got):
        assert _same(dataclasses.asdict(g), dataclasses.asdict(w))


# --------------------------------------------------------------------------- #
# tick_batch on the same MeasurementBatch
# --------------------------------------------------------------------------- #
def _hooks(negotiators):
    def make(neg):
        def hook(target, _neg=neg):
            _neg.ensure(target)
            return _neg.k_max
        return hook
    return [None if n is None else make(n) for n in negotiators]


def test_tick_batch_on_a_converted_measurement_batch_gives_the_reference_rows():
    """One reference window as a ``MeasurementBatch``, perturbed so the
    tick sees every branch (an overloaded lane, a lane with no
    measurement, an infeasible budget), through both ``tick_batch``es
    with their own negotiators: rows and errors equal."""
    ref, port = _zoo(24, seed=7, horizon=20.0, warmup=5.0)
    jr = JaxRunner(ref, tick_interval=5.0, backend="numpy")
    tr = ScenarioRunner(port, tick_interval=5.0, backend="numpy")
    w = jr.sim.step_window(jr.k, jr._steps_per_tick)
    meas, _soj = jr._window_measurement(w)
    lam = meas.lam_hat.copy()
    lam[1, 0] *= 40.0  # overload the first operator of lane 1
    lam[2, :] = np.nan  # no measurement on lane 2
    drop = meas.drop_hat.copy()
    drop[3, 0] = 0.5 * lam[3, 0]  # sustained shedding on lane 3
    meas = dataclasses.replace(meas, lam_hat=lam, drop_hat=drop)
    params = dataclasses.replace(jr._params(), k_max=jr._params().k_max.copy())
    params.k_max[4] = 1  # too small a budget
    want = jctl.tick_batch(meas, jr.k, jr.static, params, ensure=_hooks(jr.negotiators))
    got = tctl.tick_batch(measurement_from_reference(meas), tr.k,
                          static_from_reference(jr.static), params_from_reference(params),
                          ensure=_hooks(tr.negotiators))
    assert isinstance(got, tctl.BatchDecision)
    assert got.actions == want.actions
    assert {"overloaded", "none", "infeasible"} <= set(got.actions)
    for g, w_ in zip(got.rows, want.rows):
        for f in ("action", "k_next", "k_target", "k_max", "et_cur", "et_target",
                  "need_total", "reason", "applied"):
            assert _same(getattr(g, f), getattr(w_, f)), f
        assert g.code == w_.code
    assert [None if e is None else (type(e).__name__, str(e)) for e in got.errors] == \
        [None if e is None else (type(e).__name__, str(e)) for e in want.errors]
    assert [n.k_max for n in tr.negotiators if n] == [n.k_max for n in jr.negotiators if n]


# --------------------------------------------------------------------------- #
# BatchQueueSim
# --------------------------------------------------------------------------- #
def _sim_case(n=12, seed=3):
    scens = jsc.scenario_matrix(n, seed=seed, horizon=20.0, warmup=2.5, dt=0.05)
    a = jsc.pack_scenarios(scens)
    k = jsc.pack_allocations(scens, [s.plan_k0() for s in scens])
    return a, k


def test_numpy_batch_sim_equals_the_reference_twin_bitwise():
    a, k = _sim_case()
    js = jbs.BatchQueueSim(a, backend="numpy")
    ts = tbs.BatchQueueSim(_port_arrays(a), backend="numpy")
    assert ts.device is None  # host only
    while js.step_index < a.steps:
        want, got = js.step_window(k, 30), ts.step_window(k, 30)
        assert want.keys() == got.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert (ts.now, ts.step_index) == (js.now, js.step_index)
    for f in ("offered", "served", "dropped", "ext_admitted", "ext_offered", "q_final",
              "q_mean", "max_backlog", "arrival_rate", "drop_rate"):
        np.testing.assert_array_equal(getattr(ts.result(), f), getattr(js.result(), f))
    np.testing.assert_array_equal(ts.capacity(k), js.capacity(k))
    with pytest.raises(ValueError, match="exhausted"):
        ts.step_window(k)
    one = tbs.BatchQueueSim(_port_arrays(a), backend="numpy").run(k)
    np.testing.assert_array_equal(one.offered, jbs.BatchQueueSim(a).run(k).offered)


def test_torch_batch_sim_matches_the_jax_window_float32():
    """Float32 windows, the reference's ``backend="jax"`` against the
    port's torch window on the CPU, window by window (the state fed back
    as float64, a window straddling warm-up): within the pinned 2e-6 of
    ``test_torch_window`` (XLA's routing product is an FMA chain)."""
    a, k = _sim_case()
    js = jbs.BatchQueueSim(a, backend="jax")
    ts = tbs.BatchQueueSim(_port_arrays(a), backend="torch", device="cpu")
    assert ts.dtype == torch.float32
    while js.step_index < a.steps:
        want, got = js.step_window(k, 30), ts.step_window(k, 30)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=2e-6, atol=1e-6, err_msg=key)
    for f in ("offered", "served", "dropped", "ext_admitted", "q_mean", "max_backlog"):
        np.testing.assert_allclose(getattr(ts.result(), f), getattr(js.result(), f),
                                   rtol=2e-6, atol=1e-6, err_msg=f)


def test_torch_batch_sim_is_the_window_kernels_order_bitwise():
    """Each torch window equals the numpy emulation of the window kernel's
    order (float32, ``warm`` all ones) bit for bit; the window straddling
    warm-up (steps 30-59, warm-up 50) adds the reference twin's float64
    re-run on the gated mask to the whole-run sums."""
    a, k = _sim_case()
    assert a.warmup_steps == 50
    ts = tbs.BatchQueueSim(_port_arrays(a), backend="torch", device="cpu")
    caps = (ts.capacity(k) * a.dt).astype(F32)
    f32 = [a.ext.astype(F32), a.cap_queue.astype(F32), a.routing.astype(F32)]
    offered = np.zeros_like(a.mu)
    while ts.step_index < a.steps:
        t0 = ts.step_index
        n = min(30, a.steps - t0)
        q0, sp0 = ts.q.copy(), ts._served_prev.copy()
        got = ts.step_window(k, 30)
        out = np_window(q0.astype(F32), sp0.astype(F32), f32[0][t0:t0 + n], np.ones(n, F32),
                        caps, f32[1], f32[2])
        for key, i in (("q_final", 0), ("offered", 9), ("served", 10), ("dropped", 11),
                       ("ext_admitted", 12), ("ext_offered", 13)):
            np.testing.assert_array_equal(got[key], out[i].astype(np.float64), err_msg=key)
        np.testing.assert_array_equal(got["q_mean"], out[14].astype(np.float64) / n)
        warm = (np.arange(t0, t0 + n) >= a.warmup_steps).astype(np.float64)
        if warm.all():
            offered += got["offered"]
        elif warm.any():
            offered += jbs._np_window(q0, sp0, a.ext[t0:t0 + n], warm,
                                      ts.capacity(k) * a.dt, a.cap_queue, a.routing)[2]
    np.testing.assert_array_equal(ts.result().offered, offered)


def test_float64_on_a_card_is_refused_not_cast():
    a, _k = _sim_case(4)
    if torch.cuda.is_available():
        with pytest.raises(TypeError, match="float32"):
            tbs.BatchQueueSim(_port_arrays(a), device="cuda", dtype=torch.float64)
    sim = tbs.BatchQueueSim(_port_arrays(a), device="cpu", dtype=torch.float64)
    assert sim._ext.dtype == torch.float64


# --------------------------------------------------------------------------- #
# batched E[T] and traffic solve
# --------------------------------------------------------------------------- #
def _topologies(n=16, seed=9):
    ref, port = _zoo(n, seed=seed, horizon=20.0, warmup=5.0)
    rng = np.random.default_rng(seed)
    out = []
    for r, p in zip(ref, port):
        k0 = r.plan_k0()
        k = k0[None, :] + rng.integers(0, 4, (5, len(k0)))
        out.append((r.mean_topology(), p.mean_topology(), k))
    return out


def test_expected_sojourn_batch_matches_the_reference():
    for jtop, ttop, k in _topologies():
        want = jb.expected_sojourn_batch(jtop, k)
        np.testing.assert_array_equal(tb.expected_sojourn_batch(ttop, k, backend="numpy"), want)
        got = tb.expected_sojourn_batch(ttop, k, device="cpu", dtype=torch.float64)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
        got32 = tb.expected_sojourn_batch(ttop, k, device="cpu")
        np.testing.assert_allclose(got32, want, rtol=1e-5)
        T = jb.sojourn_table(jtop, int(k.max()))
        for a_, b_ in zip(tb.sojourn_from_table(T, k, jtop.arrival_rates, jtop.lam0_total),
                          jb.sojourn_from_table(T, k, jtop.arrival_rates, jtop.lam0_total)):
            np.testing.assert_array_equal(a_, b_)
    with pytest.raises(ValueError, match="k batch"):
        tb.expected_sojourn_batch(ttop, k[:, :1], backend="numpy")
    with pytest.raises(ValueError, match="unknown backend"):
        tb.expected_sojourn_batch(ttop, k, backend="jax")


def test_solve_traffic_batch_matches_the_reference():
    a, _k = _sim_case(8)
    rng = np.random.default_rng(2)
    lam0 = np.where(a.active, rng.uniform(0.0, 9.0, a.mu.shape), 0.0)
    want = jb.solve_traffic_batch(lam0, a.routing)
    np.testing.assert_array_equal(tb.solve_traffic_batch(lam0, a.routing, backend="numpy"),
                                  want)
    got = tb.solve_traffic_batch(lam0, a.routing, device="cpu", dtype=torch.float64)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    shared = a.routing[0]
    np.testing.assert_array_equal(tb.solve_traffic_batch(lam0, shared, backend="numpy"),
                                  jb.solve_traffic_batch(lam0, shared))
    with pytest.raises(ValueError, match="routing must be"):
        tb.solve_traffic_batch(lam0, a.routing[:, :2], backend="numpy")


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def test_cuda_batch_sim_window_matches_the_cpu_bitwise(cuda_device):
    a, k = _sim_case()
    card = tbs.BatchQueueSim(_port_arrays(a), device=cuda_device)
    cpu = tbs.BatchQueueSim(_port_arrays(a), device="cpu")
    LAUNCHES.clear()
    windows = 0
    while cpu.step_index < a.steps:
        want, got = cpu.step_window(k, 30), card.step_window(k, 30)
        windows += 1
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert LAUNCHES["queue_window"] == windows and LAUNCHES["queue_step"] == 0
    for f in ("offered", "served", "dropped", "ext_admitted", "q_mean", "max_backlog"):
        np.testing.assert_array_equal(getattr(card.result(), f), getattr(cpu.result(), f))


def test_cuda_expected_sojourn_batch_launches_erlang_c(cuda_device):
    for _jtop, ttop, k in _topologies(6):
        LAUNCHES.clear()
        got = tb.expected_sojourn_batch(ttop, k, device=cuda_device)
        assert LAUNCHES["erlang_c"] == 1
        np.testing.assert_allclose(got, tb.expected_sojourn_batch(ttop, k, backend="numpy"),
                                   rtol=1e-5)


def test_cuda_twin_loop_matches_the_cpu(cuda_device):
    _ref, port = _zoo(16, seed=5, horizon=20.0, warmup=5.0)
    card = ScenarioRunner(port, tick_interval=5.0, device=cuda_device)
    cpu = ScenarioRunner(port, tick_interval=5.0, device="cpu")
    LAUNCHES.clear()
    got, want = card.run(), cpu.run()
    assert LAUNCHES["queue_window"] == 4 and LAUNCHES["queue_step"] == 0
    for g, w in zip(got, want):
        assert (g.actions, g.allocations) == (w.actions, w.allocations)
