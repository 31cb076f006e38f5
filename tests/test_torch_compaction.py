"""The port's sparse (trigger-gated) decide against the JAX package and
against its own dense decide.

Compaction changes where the decide runs, never what it returns: lanes
whose decide inputs are bitwise unchanged (NaN equal to NaN) and that are
not hot replay their cached outputs, the rest are priced at the smallest
rung of a static width ladder.  So every output of the compacted
standalone decide, fused loop and float64 twin equals the dense one
bitwise (floats included: the port's per-lane ops do not depend on the
batch width on the CPU), and ``repriced`` follows the reference's trigger
lane for lane.  All five committed goldens replay through the port's
twin with compaction off and on, ``vld_proactive`` included.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

import repro.core.controller as jctl
from repro.api.session import ScenarioRunner as JaxRunner
from repro.distributed.sharding import bucket_ladder as jax_ladder
from repro.streaming import scenarios as jsc
from repro_torch.api.session import ScenarioRunner
from repro_torch.convert import (compaction_config_from_reference, mpc_config_from_reference,
                                 params_from_reference, scenario_from_reference,
                                 static_from_reference)
from repro_torch.core import controller as tctl
from repro_torch.core.measurer import MeasurementBatch
from repro_torch.distributed import bucket_ladder
from repro_torch.streaming import scenarios as tsc

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
sys.path.insert(0, str(GOLDEN))
import regen as _regen  # noqa: E402

ENTRIES = {name: (s, pro, tick) for name, s, pro, tick in _regen.entries()}


def _zoo(b, seed=11, horizon=20.0):
    ref = [s.with_(negotiated=False)
           for s in jsc.scenario_matrix(b, seed=seed, horizon=horizon, warmup=5.0, dt=0.05)]
    return ref, [scenario_from_reference(s) for s in ref]


def _decide_inputs(static, seed=0, k_fill=2):
    b, n = static.batch, static.n
    rng = np.random.default_rng(seed)
    lam = np.abs(rng.normal(2.0, 0.5, (b, n)))
    mu = np.abs(rng.normal(6.0, 0.5, (b, n))) + 1.0
    drop = np.zeros((b, n))
    lam0 = np.abs(rng.normal(2.0, 0.5, b))
    k = np.where(static.active, k_fill, 0).astype(np.int64)
    return lam, mu, drop, lam0, k


def _eq_nan(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, dict):
        return set(a) == set(b) and all(_eq_nan(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_eq_nan(x, y) for x, y in zip(a, b))
    return a == b


def _bitwise(want, got, keys=None):
    keys = sorted(want) if keys is None else keys
    for key in keys:
        w, g = want[key], got[key]
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert w.dtype == g.dtype, key
        np.testing.assert_array_equal(g, w, err_msg=key)


# --------------------------------------------------------------------------- #
# the ladder
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("b", [1, 3, 7, 16, 4096, 10_000])
def test_bucket_ladder_equals_the_reference(b):
    assert bucket_ladder(b) == jax_ladder(b)
    assert bucket_ladder(b, fractions=(2,)) == jax_ladder(b, fractions=(2,))
    assert bucket_ladder(b)[-1] == b


def test_bucket_ladder_refuses_an_empty_batch_and_resolves_custom_caps():
    with pytest.raises(ValueError):
        bucket_ladder(0)
    assert tctl._resolve_ladder(tctl.CompactionConfig(b_active_cap=(2, 99)), 8) == (2, 8)
    assert tctl._resolve_ladder(True, 4096) == (256, 1024, 4096)
    with pytest.raises(ValueError, match=">= 1"):
        tctl._resolve_ladder(tctl.CompactionConfig(b_active_cap=(0,)), 8)
    cfg = compaction_config_from_reference(jctl.CompactionConfig(b_active_cap=(2, 8)))
    assert cfg == tctl.CompactionConfig(b_active_cap=(2, 8))


# --------------------------------------------------------------------------- #
# the standalone decide
# --------------------------------------------------------------------------- #
def _fleet(b, seed=11):
    ref, _port = _zoo(b, seed=seed)
    runner = JaxRunner(ref, tick_interval=5.0, backend="numpy", fused=False)
    return runner.static, runner._params()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("fused", [False, True])
def test_compacted_decide_equals_the_dense_decide_and_the_reference_trigger(dtype, fused):
    """Cold, quiet and partly changed ticks at swept trigger fractions: every
    output bitwise the dense decide's, and ``repriced`` the JAX compacted
    decide's, lane for lane (x64)."""
    jst, jpr = _fleet(32)
    st, pr = static_from_reference(jst), params_from_reference(jpr)
    lam, mu, drop, lam0, k = _decide_inputs(st)
    dense = tctl.make_decide(st, pr, fused=fused, device="cpu", dtype=dtype)
    comp = tctl.make_decide(st, pr, fused=fused, compact=True, device="cpu", dtype=dtype)
    cache = comp.init_cache()
    with jax.enable_x64(True):
        jcomp = jctl.make_decide_jax(jst, jpr, compact=True)
        jcache = jcomp.init_cache()

    def check(lam_t, k_t=k):
        nonlocal cache, jcache
        want = dense(lam_t, mu, drop, lam0, k_t)
        got, repriced, cache = comp(lam_t, mu, drop, lam0, k_t, cache)
        for i, (w, g) in enumerate(zip(want, got)):
            assert w.dtype == g.dtype
            np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=f"out[{i}]")
        with jax.enable_x64(True):
            _out, jrep, jcache = jcomp(lam_t, mu, drop, lam0, k_t, jcache)
        np.testing.assert_array_equal(repriced.numpy(), np.asarray(jrep))
        return int(repriced.sum())

    assert check(lam) == 32  # cold: every lane priced
    assert check(lam) == 0  # unchanged: every lane replays
    for frac in (0.05, 0.25, 0.5, 1.0):
        n_trig = max(int(round(frac * 32)), 1)
        lam2 = lam.copy()
        lam2[:n_trig] *= 1.0 + 0.01 * frac
        assert check(lam2) == n_trig
        assert check(lam2) == 0
    assert check(lam) == 32  # every lane back to the first rates
    k2 = k.copy()
    k2[1, 0] += 1
    assert check(lam, k2) == 1  # an allocation change triggers like a rate change
    lam3 = lam.copy()
    lam3[2] = np.nan  # NaN equals NaN in the trigger: an idle lane goes quiet
    assert check(lam3, k2) == 1
    assert check(lam3, k2) == 0


def test_compacted_decide_runs_on_its_ladder_rungs(monkeypatch):
    """The repriced lanes are priced at the smallest rung that holds them,
    the clipped tail rows never land, and no rung runs when no lane is
    repriced."""
    jst, jpr = _fleet(8)
    st, pr = static_from_reference(jst), params_from_reference(jpr)
    lam, mu, drop, lam0, k = _decide_inputs(st)
    widths = []
    real = tctl._make_decide_core

    def spy(*args, **kw):
        core = real(*args, **kw)

        def counted(st_, lam_, *rest):
            widths.append(lam_.shape[0])
            return core(st_, lam_, *rest)

        return counted

    monkeypatch.setattr(tctl, "_make_decide_core", spy)
    dense = tctl.make_decide(st, pr, device="cpu", dtype=torch.float64)
    comp = tctl.make_decide(st, pr, compact=tctl.CompactionConfig(b_active_cap=(2, 4)),
                            device="cpu", dtype=torch.float64)
    cache = comp.init_cache()
    for lam_t, want_w in ((lam, 8), (lam, None), (lam * np.where(np.arange(8) == 5, 1.01, 1.0)[:, None], 2),
                          (lam * np.where(np.arange(8) < 3, 1.02, 1.0)[:, None], 4)):
        widths.clear()
        got, repriced, cache = comp(lam_t, mu, drop, lam0, k, cache)
        assert widths == ([] if want_w is None else [want_w])
        widths.clear()
        want = dense(lam_t, mu, drop, lam0, k)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), w.numpy())


# --------------------------------------------------------------------------- #
# the fused loop
# --------------------------------------------------------------------------- #
EXACT_KEYS = ("codes", "k", "applied", "sojourn", "et_cur", "et_target", "miss",
              "k_final", "q_final", "offered", "served", "dropped", "ext_admitted",
              "ext_offered", "q_int", "q_max")


def _fused_out(port, compact, dtype, **kw):
    runner = ScenarioRunner(port, tick_interval=5.0, compact=compact, device="cpu",
                            dtype=dtype, **kw)
    assert runner.fused
    runner.run()
    return runner.outputs


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("seed", [11, 29])
def test_fused_loop_compact_is_bitwise_the_dense_loop_on_the_zoo(seed, dtype):
    """The 32-scenario mixed zoo (Poisson lanes reprice every window,
    constant ones go quiet): every output of the compacted loop bitwise
    the dense loop's, float outputs included."""
    _ref, port = _zoo(32, seed=seed)
    want = _fused_out(port, None, dtype)
    got = _fused_out(port, True, dtype)
    assert "repriced" not in want and got["repriced"].shape == want["codes"].shape
    _bitwise(want, got, EXACT_KEYS)
    assert got["repriced"][0].all()


@pytest.mark.parametrize("fused_decide", [False, True])
def test_fused_loop_compact_proactive_is_bitwise_the_dense_loop(fused_decide):
    """The 16-scenario zoo with the forecast/MPC plane: decisions, the
    plan's use and confidence, and every float output bitwise."""
    _ref, port = _zoo(16)
    kw = dict(proactive=True, fused_decide=fused_decide)
    want = _fused_out(port, None, torch.float32, **kw)
    got = _fused_out(port, True, torch.float32, **kw)
    _bitwise(want, got, EXACT_KEYS + ("mpc_used", "confident"))


def _quiet_zoo():
    ref = [dataclasses.replace(s.with_(negotiated=False), arrival_kind="deterministic")
           for s in jsc.scenario_matrix(8, seed=11, horizon=40.0, warmup=5.0, dt=0.05)
           if "constant" in s.name]
    assert ref, "the matrix zoo lost its constant-trace scenarios"
    return ref, [scenario_from_reference(s) for s in ref]


def test_fused_loop_quiet_lanes_stop_repricing():
    """Deterministic constant lanes measure bitwise the same windows once
    the transient drains: the trigger stops repricing them (repriced falls
    to 0), and the outputs stay the dense loop's."""
    _ref, port = _quiet_zoo()
    want = _fused_out(port, None, torch.float32)
    got = _fused_out(port, True, torch.float32)
    _bitwise(want, got, EXACT_KEYS)
    repriced = got["repriced"]
    assert repriced[0].all()
    assert not repriced[-1].any(), repriced
    assert repriced.sum() < repriced.size


def test_fused_loop_repriced_follows_the_reference_trigger():
    """Float64 on both sides: the port's compacted loop reprices the lanes
    the JAX compacted loop reprices, tick for tick, with the same
    decisions."""
    ref, port = _quiet_zoo()
    with jax.enable_x64(True):
        jr = JaxRunner(ref, tick_interval=5.0, backend="jax", compact=True)
        loop, _ = jctl.make_fused_loop(jr.arrays, jr.static, jr._params(),
                                       steps_per_tick=jr._steps_per_tick,
                                       warmup_seconds=ref[0].warmup, compact=True)
        want = {k: np.asarray(v) for k, v in loop(jr.k).items()}
    got = _fused_out(port, True, torch.float64)
    for key in ("repriced", "codes", "k", "applied"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_chunked_compacted_runs_start_cold_and_stay_exact():
    """The memo rides only inside one ``run`` call: a resumed chunk prices
    every lane once more, with unchanged outputs."""
    jst, jpr = _fleet(8)
    ref, port = _zoo(8)
    r = ScenarioRunner(port, tick_interval=5.0, device="cpu")
    loop, n_ticks = tctl.make_fused_loop(r.arrays, r.static, r.params,
                                         steps_per_tick=r._steps_per_tick, compact=True,
                                         device="cpu")
    dense, _ = tctl.make_fused_loop(r.arrays, r.static, r.params,
                                    steps_per_tick=r._steps_per_tick, device="cpu")
    state, first = loop.run(loop.init(r.k), 2)
    _state, rest = loop.run(state)
    assert first["repriced"][0].all() and rest["repriced"][0].all()
    want = dense(r.k)
    for key in ("codes", "k", "et_cur"):
        np.testing.assert_array_equal(
            np.concatenate([first[key].numpy(), rest[key].numpy()]), want[key].numpy())


# --------------------------------------------------------------------------- #
# the float64 twin
# --------------------------------------------------------------------------- #
def test_twin_compact_trace_is_the_dense_trace_and_the_reference():
    ref, port = _zoo(32)
    want = jsc.control_trace(ref, tick_interval=5.0, compact=True)
    dense = tsc.control_trace(port, tick_interval=5.0, backend="numpy")
    got = tsc.control_trace(port, tick_interval=5.0, backend="numpy", compact=True)
    assert _eq_nan(got, dense)
    assert _eq_nan(got, want)


def test_twin_compact_proactive_trace_is_the_dense_trace_and_the_reference():
    ref, port = _zoo(8)
    want = jsc.control_trace(ref, tick_interval=5.0, proactive=True, compact=True)
    dense = tsc.control_trace(port, tick_interval=5.0, proactive=True, backend="numpy")
    got = tsc.control_trace(port, tick_interval=5.0, proactive=True, backend="numpy",
                            compact=True)
    assert _eq_nan(got, dense)
    assert _eq_nan(got, want)


def test_twin_compaction_state_replays_and_isolates_the_caller():
    """The twin's memo engages on a repeated window, replays a copy of the
    cached row (a caller mutating it does not reach the cache), and a
    lease hook keeps a lane out of the memo."""
    _ref, port = _zoo(6)
    r = ScenarioRunner(port, tick_interval=5.0, backend="numpy")
    cstate = tctl.TwinCompactionState.create(len(port), r.static.n)
    lam, mu, drop, lam0, k = _decide_inputs(r.static)
    meas = MeasurementBatch.from_rates(lam, mu, lam0, np.full(len(port), 0.2), 0.0,
                                       drop_hat=drop)
    out1 = tctl.tick_batch(meas, k, r.static, r._params(), compact_state=cstate)
    assert not cstate.replayed.any()
    out2 = tctl.tick_batch(meas, k, r.static, r._params(), compact_state=cstate)
    assert cstate.replayed.all()
    for r1, r2 in zip(out1.rows, out2.rows):
        assert r1 == dataclasses.replace(r2, k_next=r1.k_next)
        np.testing.assert_array_equal(r1.k_next, r2.k_next)
    out2.rows[0].k_next[:] = -7
    out3 = tctl.tick_batch(meas, k, r.static, r._params(), compact_state=cstate)
    assert (out3.rows[0].k_next >= 0).all()
    hooks = [None] * len(port)
    hooks[3] = lambda target: int(r.params.k_max[3])
    tctl.tick_batch(meas, k, r.static, r._params(), ensure=hooks, compact_state=cstate)
    assert cstate.replayed.tolist() == [True, True, True, False, True, True]


@pytest.mark.parametrize("compact", [None, True])
@pytest.mark.parametrize("name", ["vld", "fpd", "vld_proactive", "vld_fused", "soak"])
def test_golden_trace_replays_through_the_port_twin(name, compact):
    """Every committed golden through ``control_trace(backend="numpy")``,
    with compaction off and on: the fixture and the reference's trace,
    bit for bit (``vld_proactive`` runs the forecast/MPC plane)."""
    scenario, proactive, tick = ENTRIES[name]
    want = json.loads((GOLDEN / f"{name}_control_trace.json").read_text())
    pro = None if proactive is None else mpc_config_from_reference(proactive)
    got = tsc.control_trace([scenario_from_reference(scenario)], tick_interval=tick,
                            proactive=pro, backend="numpy", compact=compact)
    assert got == want
    if compact:
        ref = jsc.control_trace([scenario], tick_interval=tick, proactive=proactive,
                                compact=True)
        assert got == ref


def expected_calls(out, n_ticks, *, fused_decide, proactive, compact):
    """The loop kernels' calls per run, the rule ``chip_smoke.py`` holds the
    card's launch counters to: per tick one ``queue_window`` and one
    ``erlang_c`` (``stationary_wait``'s table); the decide runs one
    ``decide_fused`` (fused) or one ``erlang_c`` and one ``gain_topr``
    (two-pass); the planner one ``erlang_c`` and one ``decide_fused``
    (fused) or ``gain_topr`` (two-pass).  Under compaction the decide runs
    on a tick only when it reprices a lane, the planner only when a lane
    is eligible."""
    ticks = np.arange(n_ticks)
    dec = (out["repriced"].any(axis=1) if compact else np.ones(n_ticks, bool)).astype(int)
    mpc = np.zeros(n_ticks, int)
    if proactive:
        mpc = (out["eligible"].any(axis=1) if compact else np.ones(n_ticks, bool)).astype(int)
    return {
        "queue_step": 0, "queue_window": int(ticks.size),
        "erlang_c": int(ticks.size + (0 if fused_decide else dec.sum()) + mpc.sum()),
        "gain_topr": 0 if fused_decide else int(dec.sum() + mpc.sum()),
        "decide_fused": int(dec.sum() + mpc.sum()) if fused_decide else 0,
    }


@pytest.mark.parametrize("compact", [None, True])
@pytest.mark.parametrize("fused_decide", [False, True])
def test_loop_kernel_calls_follow_the_stated_rule(monkeypatch, fused_decide, compact):
    """Every call of a loop kernel's ``ops`` face during a proactive run,
    counted on the CPU, against the rule derived from the run's own
    ``repriced`` / ``eligible``; the quiet zoo skips decide rungs."""
    from repro_torch.kernels.decide_fused import ops as fo
    from repro_torch.kernels.erlang_c import ops as eo
    from repro_torch.kernels.gain_topr import ops as go
    from repro_torch.kernels.queue_step import ops as qo

    calls = {}

    def counting(mod, attr, name):
        real = getattr(mod, attr)

        def wrapped(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return real(*a, **kw)

        monkeypatch.setattr(mod, attr, wrapped)

    counting(eo, "erlang_b_table", "erlang_c")
    counting(go, "gain_topr", "gain_topr")
    counting(fo, "batch_decide", "decide_fused")
    counting(qo, "queue_window", "queue_window")
    counting(qo, "queue_step", "queue_step")
    _ref, port = _quiet_zoo()
    runner = ScenarioRunner(port * 2, tick_interval=5.0, proactive=True, compact=compact,
                            fused_decide=fused_decide, device="cpu")
    runner.run()
    out = runner.outputs
    n_ticks = out["codes"].shape[0]
    want = expected_calls(out, n_ticks, fused_decide=fused_decide, proactive=True,
                          compact=compact)
    assert {k: calls.get(k, 0) for k in want} == want
    if compact:
        assert set(out) >= {"repriced", "eligible"}
        assert not out["repriced"][-1].any()
