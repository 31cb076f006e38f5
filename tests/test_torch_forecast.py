"""The port's forecast/MPC plane against the JAX package.

Both faces of ``repro_torch.forecast``: the numpy face (the float64 twin)
equals the reference's ``xp=np`` path bitwise, the torch face equals it to
<= 1e-9 in float64 (integer outputs exact; on these inputs it is bitwise
too).  The plane wired in: the proactive fused loop (CPU float64) against
the port's twin, the port's float32 proactive loop against the JAX float32
``make_fused_loop(proactive=...)``, and the live ``DRSScheduler(proactive=)``
against the reference's.  The card tests hold the loop kernels at the
planner's shapes (3B rows, ``k_cur = 0``) against their plain versions.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.core.controller as jctl
from repro.api.session import ScenarioRunner as JaxRunner
from repro.core.measurer import MeasurementSnapshot as JaxSnapshot
from repro.core.scheduler import DRSScheduler as JaxScheduler, SchedulerConfig as JaxConfig
from repro.forecast import mpc as jm, predictors as jp
from repro.streaming.scenarios import ArrivalTrace as JaxTrace, scenario_matrix, vld_scenario
from repro_torch.api.graph import AppGraph
from repro_torch.api.session import DRSSession, ScenarioRunner
from repro_torch.convert import (forecast_state_from_reference, from_reference,
                                 mpc_config_from_reference, predictor_params_from_reference,
                                 scenario_from_reference)
from repro_torch.core import controller as tctl
from repro_torch.core.measurer import MeasurementSnapshot
from repro_torch.core.scheduler import DRSScheduler, SchedulerConfig
from repro_torch.forecast import mpc as tm, predictors as tp
from repro_torch.kernels.decide_fused import ops as fused_ops, ref as fused_ref
from repro_torch.kernels.erlang_c import ref as erlang_ref
from repro_torch.kernels.gain_topr import ref as topr_ref

ATOL = 1e-9  # the reference's twin/jit agreement bound, float64


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(got, want, name):
    """float64 torch vs numpy: the same non-finite pattern, finite values
    within ATOL; integers and booleans exact."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want), err_msg=name)
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=ATOL, rtol=0, err_msg=name)


# --------------------------------------------------------------------------- #
# predictors
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", ["ewma", "holt", "seasonal"])
def test_forecast_rates_match_the_reference(kind):
    rng = np.random.default_rng(3)
    hist = rng.uniform(1.0, 25.0, (5, 12, 4))
    hist[1, :, 2] = 0.0  # an idle operator
    jpp = jp.PredictorParams(kind=kind, alpha=0.55, beta=0.35,
                             season=6 if kind == "seasonal" else 0)
    pp = predictor_params_from_reference(jpp)
    want = jp.forecast_rates(hist, 4, jpp, xp=np)
    np.testing.assert_array_equal(tp.forecast_rates(hist, 4, pp), want)
    got = tp.forecast_rates_torch(_t(hist), 4, pp)
    assert got.shape == want.shape and got.dtype == torch.float64
    _close(got, want, kind)


def test_predictor_params_validate_as_the_reference():
    for kw in (dict(kind="nope"), dict(kind="holt", alpha=1.5), dict(kind="seasonal")):
        with pytest.raises(ValueError):
            jp.PredictorParams(**kw)
        with pytest.raises(ValueError):
            tp.PredictorParams(**kw)
    with pytest.raises(ValueError, match="season"):
        tm.MPCConfig(window=4, predictor=tp.PredictorParams(kind="seasonal", season=6))
    with pytest.raises(ValueError):
        tp.forecast_rates_torch(torch.zeros(1, 3, 1), 0, tp.PredictorParams())


def test_error_tracking_and_gate_match_the_reference():
    """A seeded run of history pushes, error updates and gates, both faces
    against the reference's numpy path (one operator lane inactive)."""
    rng = np.random.default_rng(9)
    b, w, n = 4, 6, 3
    active = np.ones((b, n), dtype=bool)
    active[2, 2] = False
    js, ns = jp.error_init(b, n), tp.error_init(b, n)
    ts = tp.error_init_torch(b, n, dtype=torch.float64, device="cpu")
    jh, nh = jp.history_init(b, w, n), tp.history_init(b, w, n)
    th = tp.history_init_torch(b, w, n, dtype=torch.float64, device="cpu")
    for step in range(8):
        y = rng.uniform(0.0, 20.0, (b, n)) * (step % 3 != 1)
        pred = rng.uniform(0.0, 20.0, (b, n))
        jh = jp.history_push(jh, y, js[5])
        nh = tp.history_push(nh, y, ns[5])
        th = tp.history_push_torch(th, _t(y), ts[5])
        js = jp.error_update(js, pred, y)
        ns = tp.error_update(ns, pred, y)
        ts = tp.error_update_torch(ts, _t(pred), _t(y))
        np.testing.assert_array_equal(nh, jh)
        _close(th, jh, "history")
        for a, c, d in zip(js, ns, ts):
            np.testing.assert_array_equal(c, a)
            _close(d, a, "errors")
        kw = dict(min_scored=3, mase_gate=2.0, smape_gate=0.9)
        want = jp.confidence(js, active, **kw)
        np.testing.assert_array_equal(tp.confidence(ns, active, **kw), want)
        np.testing.assert_array_equal(tp.confidence_torch(ts, _t(active), **kw).numpy(), want)
        _close(tp.mase_torch(ts), jp.mase(js), "mase")
        _close(tp.smape_torch(ts), jp.smape(js), "smape")


def test_forecast_step_matches_the_reference_from_a_carried_state():
    """``forecast_step`` from a reference state carried across by
    ``convert.forecast_state_from_reference``: state, forecast and gate."""
    jcfg = jm.MPCConfig(horizon=3, window=5, min_scored=2)
    cfg = mpc_config_from_reference(jcfg)
    rng = np.random.default_rng(1)
    b, n = 3, 4
    active = np.ones((b, n), dtype=bool)
    active[0, 3] = False
    js = jm.forecast_init_state(b, n, jcfg)
    for _ in range(4):
        js, _p, _c = jm.forecast_step(js, rng.uniform(1, 9, (b, n)), active, jcfg)
    lam = rng.uniform(1, 9, (b, n))
    lam[1, 1] = np.nan
    want = jm.forecast_step(js, lam, active, jcfg)
    got_np = tm.forecast_step(forecast_state_from_reference(js), lam, active, cfg)
    got_t = tm.forecast_step_torch(
        forecast_state_from_reference(js, device="cpu", dtype=torch.float64), _t(lam),
        _t(active), cfg)
    for a, c in zip(want[0], got_np[0]):
        np.testing.assert_array_equal(c, a)
    np.testing.assert_array_equal(got_np[1], want[1])
    np.testing.assert_array_equal(got_np[2], want[2])
    for a, d in zip(want[0], got_t[0]):
        _close(d, a, "state")
    _close(got_t[1], want[1], "lam_pred")
    np.testing.assert_array_equal(got_t[2].numpy(), want[2])


# --------------------------------------------------------------------------- #
# the planner
# --------------------------------------------------------------------------- #
def _plan_case(variant):
    """``test_mpc_plan_twin_vs_jit``'s inputs, and a variant with gang
    lanes, bounded queues, an inactive lane and a budget the floor
    exceeds."""
    rng = np.random.default_rng(17)
    b, n, hzn, k_hi = 6, 4, 3, 40
    lam_pred = rng.uniform(1.0, 18.0, (b, hzn, n))
    q0 = rng.uniform(0.0, 8.0, (b, n))
    k_cur = rng.integers(1, 7, (b, n)).astype(np.int64)
    kw = dict(
        mu=rng.uniform(2.0, 9.0, (b, n)), group=np.zeros((b, n), dtype=bool),
        alpha=np.zeros((b, n)), speed=np.ones((b, n)), active=np.ones((b, n), dtype=bool),
        src_mask=(np.arange(n)[None, :] == 0).repeat(b, axis=0),
        cap_queue=np.full((b, n), np.inf),
        t_max=np.where(np.arange(b) % 2 == 0, 3.0, np.inf),
        k_max=np.full(b, 48, dtype=np.int64), span=10.0, k_hi=k_hi,
    )
    if variant == "mixed":
        kw["group"][:, 1] = True
        kw["alpha"][:, 1] = 0.05
        kw["speed"][:, 2] = 1.5
        kw["active"][3, 3] = False
        kw["cap_queue"][:, 0] = 30.0
        kw["t_max"] = np.full(b, 2.0)
        kw["k_max"][4] = 3  # below the floor: no candidate fits
    return lam_pred, q0, k_cur, kw


def _torch_kw(kw, dtype=torch.float64):
    out = {}
    for key, v in kw.items():
        if isinstance(v, np.ndarray):
            v = torch.as_tensor(v)
            if v.is_floating_point():
                v = v.to(dtype)
        out[key] = v
    return out


@pytest.mark.parametrize("variant", ["jit_case", "mixed"])
def test_mpc_plan_matches_the_reference(variant):
    """The numpy face bitwise, the torch face (float64, CPU) within 1e-9
    with k_plan / any_ok / need exact."""
    lam_pred, q0, k_cur, kw = _plan_case(variant)
    jcfg = jm.MPCConfig(horizon=3, window=12)
    cfg = mpc_config_from_reference(jcfg)
    want = jm.mpc_plan(lam_pred, q0, k_cur, cfg=jcfg, xp=np, **kw)
    got_np = tm.mpc_plan(lam_pred, q0, k_cur, cfg=cfg, **kw)
    got_t = tm.mpc_plan_torch(_t(lam_pred), _t(q0), _t(k_cur), cfg=cfg, **_torch_kw(kw))
    names = ("k_plan", "any_ok", "et_hold", "et_plan", "need")
    for name, a, c, d in zip(names, want, got_np, got_t):
        np.testing.assert_array_equal(c, np.asarray(a), err_msg=name)
        _close(d, np.asarray(a), name)
    assert np.asarray(want[1]).any() and not np.asarray(want[1]).all()


def test_mpc_plan_compact_matches_the_reference_on_empty_and_subset_masks():
    b, n, h = 4, 3, 3
    rng = np.random.default_rng(5)
    lam_pred = np.abs(rng.normal(3.0, 0.5, (b, h, n)))
    q0 = np.abs(rng.normal(1.0, 0.3, (b, n)))
    k_cur = np.full((b, n), 2, dtype=np.int64)
    k_max = np.full(b, 12, dtype=np.int64)
    src_mask = np.zeros((b, n), dtype=bool)
    src_mask[:, 0] = True
    kw = dict(mu=np.abs(rng.normal(6.0, 0.5, (b, n))) + 1.0, group=np.zeros((b, n), dtype=bool),
              alpha=np.zeros((b, n)), speed=np.ones((b, n)), active=np.ones((b, n), dtype=bool),
              src_mask=src_mask, cap_queue=np.full((b, n), np.inf), t_max=np.full(b, 2.0),
              span=5.0, k_hi=16)
    jcfg = jm.MPCConfig(horizon=h)
    cfg = mpc_config_from_reference(jcfg)
    for eligible in (np.array([True, False, True, False]), np.zeros(b, dtype=bool)):
        want = jm.mpc_plan_compact(eligible, lam_pred, q0, k_cur, k_max=k_max, cfg=jcfg,
                                   xp=np, **kw)
        got = tm.mpc_plan_compact(eligible, lam_pred, q0, k_cur, k_max=k_max, cfg=cfg, **kw)
        for a, c in zip(want, got):
            np.testing.assert_array_equal(c, np.asarray(a))
            assert c.dtype == np.asarray(a).dtype
    dense = tm.mpc_plan(lam_pred, q0, k_cur, k_max=k_max, cfg=cfg, **kw)
    got = tm.mpc_plan_compact(np.array([True, False, True, False]), lam_pred, q0, k_cur,
                              k_max=k_max, cfg=cfg, **kw)
    for d, c in zip(dense, got):
        np.testing.assert_array_equal(c[[0, 2]], np.asarray(d)[[0, 2]])


@pytest.mark.parametrize("shape", [(3, 4, 5), (2, 7)])
def test_mpc_table_on_torch_is_the_numpy_table_bitwise(shape):
    """The torch table (one Erlang-B pass over the flattened loads) on CPU
    float64 equals the numpy ``sojourn_table_arrays`` of both packages
    bitwise: the same ops in the same order, op for op."""
    rng = np.random.default_rng(2)
    mu = rng.uniform(1.0, 9.0, shape)
    lam = mu * rng.uniform(0.0, 6.0, shape)
    lam.ravel()[::5] = 0.0
    group = rng.random(shape) < 0.3
    alpha = np.where(group, 0.03, 0.0)
    want = jm.sojourn_table_arrays(lam, mu, group, alpha, 24, xp=np)
    np.testing.assert_array_equal(tm.sojourn_table_arrays(lam, mu, group, alpha, 24), want)
    got = tm.sojourn_table_arrays_torch(_t(lam), _t(mu), _t(group), _t(alpha), 24)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_erlang_plain_recurrence_is_the_reference_formula_bitwise(dtype):
    """The plain ``erlang_b_table`` forms ``ab / (ab + j)``; the reference's
    planner table forms ``a b / (j + a b)``: addition commutes exactly, so
    every row is the same bits (float32 and float64)."""
    a = np.random.default_rng(4).uniform(0.0, 60.0, 4096).astype(dtype)
    a[:7] = [0.0, 1e-30, 1.0, 47.0, 48.0, 59.9, 1e-3]
    b = np.ones_like(a)
    rows = [b]
    for j in range(1, 49):
        b = a * b / (j + a * b)
        rows.append(b)
    want = np.stack(rows)
    got = erlang_ref.erlang_b_table(torch.as_tensor(a), k_hi=48).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mpc_fused_allocator_is_the_top_r_route_bitwise(dtype):
    """``decide_fused`` as the planner's allocator (3B rows, ``k_cur = 0``,
    the candidate budgets as ``k_max``, ``j_cap = max(k_max)``): the plan
    equals the two-pass top-R route's bitwise.  The budgets the pass
    spends stay <= j_cap, so its window past the floor holds every take."""
    lam_pred, q0, k_cur, kw = _plan_case("mixed")
    cfg = tm.MPCConfig(horizon=3)
    tkw = _torch_kw(kw, dtype)
    j_cap = int(kw["k_max"].max())
    mu_eff = tkw["mu"] * tkw["speed"]
    seen = []

    def alloc(lam_m, budgets_m):
        bx, m = mu_eff.shape[0], lam_m.shape[0]

        def rep(x):
            return x[:, None, :].expand(bx, m // bx, x.shape[-1]).reshape(m, -1)

        assert int(budgets_m.max()) <= j_cap
        seen.append(m)
        return fused_ops.batch_decide(
            lam_m, rep(mu_eff), group=rep(tkw["group"]), alpha=rep(tkw["alpha"]),
            active=rep(tkw["active"]), k_cur=torch.zeros(lam_m.shape, dtype=torch.int32),
            k_max=budgets_m.to(torch.int32), k_hi=kw["k_hi"], j_cap=j_cap)[0]

    args = (_t(lam_pred).to(dtype), _t(q0).to(dtype), _t(k_cur))
    want = tm.mpc_plan_torch(*args, cfg=cfg, **tkw)
    got = tm.mpc_plan_torch(*args, cfg=cfg, alloc=alloc, **tkw)
    assert seen == [3 * lam_pred.shape[0]]
    for name, w, g in zip(("k_plan", "any_ok", "et_hold", "et_plan", "need"), want, got):
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)


# The planner's Program-(6) count reads a prefix sum of up to N k_hi sorted
# gains.  In float32 it rounds three ways: the port on the CPU (torch
# accumulates a float32 cumsum in double and rounds each output once),
# XLA's cumsum (a tree), and the port on the card (a tree too).  A count
# could differ only where E[T] after m increments lies within these few
# ulps of T_max; no tested fleet has such a lane (the float32 loop matches
# the JAX loop, and the card the CPU, on every plan).
PREFIX_ULPS = 8  # bound on the float32 prefix sum's error, in ulps of the exact sum


def _sorted_gains(seed, rows=256, cols=336):
    rng = np.random.default_rng(seed)
    return -np.sort(-rng.gamma(0.5, 1.0, (rows, cols)).astype(np.float32), axis=-1)


def test_planner_prefix_sum_rounds_unlike_xla_in_float32():
    import jax.numpy as jnp

    worst = 0.0
    for seed in range(8):
        g = _sorted_gains(seed)
        exact = np.cumsum(g.astype(np.float64), axis=-1)
        port = torch.cumsum(torch.from_numpy(g), dim=-1).numpy()
        np.testing.assert_array_equal(port, exact.astype(np.float32))  # correctly rounded
        xla = np.asarray(jnp.cumsum(jnp.asarray(g), axis=-1))
        worst = max(worst, float(np.max(np.abs(xla - exact) / np.spacing(port))))
        assert not np.array_equal(xla, port)
    assert 0.0 < worst <= PREFIX_ULPS


# --------------------------------------------------------------------------- #
# the plane end to end
# --------------------------------------------------------------------------- #
def _ramp(**kw):
    t5 = np.arange(0.0, 151.0, 5.0)
    ramp = np.interp(t5, [0, 50, 90, 110, 150], [8, 8, 24, 24, 10])
    defaults = dict(
        traces={"extract": JaxTrace(kind="replay", samples=tuple(ramp), sample_dt=5.0)},
        t_max=1.2, queue_capacity=200, machine_size=1, horizon=150.0,
    )
    defaults.update(kw)
    return vld_scenario(**defaults)


def _jcfg():
    return jm.MPCConfig(horizon=3, window=12, min_scored=2,
                        predictor=jp.PredictorParams(kind="holt", alpha=0.6, beta=0.4))


def test_proactive_twin_runs_the_reference_twin_bitwise():
    """The negotiated ramp through both twins: reports, decisions (leases
    follow the plan) and trajectories, ``mpc_used`` / ``confident``
    included."""
    ref = _ramp()
    want = JaxRunner([ref], tick_interval=10.0, backend="numpy", proactive=_jcfg()).run()[0]
    got = ScenarioRunner([scenario_from_reference(ref)], tick_interval=10.0, backend="numpy",
                         proactive=mpc_config_from_reference(_jcfg())).run()[0]
    assert "proactive" in got.actions and any(got.trajectory["mpc_used"])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("fused_decide", [False, True])
def test_proactive_fused_loop_matches_the_port_twin_float64(fused_decide):
    """The static-budget ramp on the CPU in float64: the fused loop (MPC
    through gain_topr, or decide_fused as its allocator) and the port's
    float64 twin commit the same actions, totals and plans."""
    port = scenario_from_reference(_ramp(negotiated=False))
    cfg = mpc_config_from_reference(_jcfg())
    twin = ScenarioRunner([port], tick_interval=10.0, backend="numpy", proactive=cfg).run()[0]
    runner = ScenarioRunner([port], tick_interval=10.0, proactive=cfg, device="cpu",
                            dtype=torch.float64, fused_decide=fused_decide)
    assert runner.fused
    fused = runner.run()[0]
    assert "proactive" in fused.actions
    assert list(fused.actions) == list(twin.actions)
    assert fused.k_final == twin.k_final
    for key in ("k_total", "mpc_used", "confident"):
        assert fused.trajectory[key] == twin.trajectory[key], key


@pytest.mark.parametrize("fused_decide", [False, True])
def test_proactive_fused_loop_matches_jax_fused_loop_float32(fused_decide):
    """The port's float32 proactive loop against the JAX float32
    ``make_fused_loop(proactive=...)`` on the ramp and an 8-scenario zoo:
    codes, allocations, ``mpc_used`` / ``confident`` exact, floats within
    rtol 1e-6 (the decide's routing product and traffic solve round
    differently in XLA and PyTorch, test_torch_slice)."""
    scens = [_ramp(negotiated=False)] + [
        s.with_(negotiated=False)
        for s in scenario_matrix(7, seed=31, horizon=150.0, warmup=10.0, dt=0.05)]
    runner = JaxRunner(scens, tick_interval=10.0, backend="numpy", fused=False,
                       fused_decide=fused_decide)
    params = runner._params()
    loop_j, n_ticks = jctl.make_fused_loop(runner.arrays, runner.static, params,
                                           steps_per_tick=runner._steps_per_tick,
                                           warmup_seconds=scens[0].warmup,
                                           proactive=_jcfg())
    want = {k: np.asarray(v) for k, v in loop_j(runner.k).items()}
    arrays, static, pr, _state = from_reference(runner.arrays, runner.static, params,
                                                runner.k, device="cpu")
    loop_t, _ = tctl.make_fused_loop(arrays, static, pr,
                                     steps_per_tick=runner._steps_per_tick,
                                     warmup_seconds=scens[0].warmup,
                                     proactive=mpc_config_from_reference(_jcfg()),
                                     device="cpu", dtype=torch.float32)
    got = {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
           for k, v in loop_t(runner.k).items()}
    assert set(got) == set(want)
    for key in ("codes", "k", "applied", "mpc_used", "confident", "k_final", "miss",
                "warm_windows"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("sojourn", "et_cur", "et_target", "q_final", "offered", "served",
                "dropped", "ext_admitted", "ext_offered", "q_int", "q_max"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-6,
                                   equal_nan=True, err_msg=key)
    assert (got["codes"] == tctl.ACTIONS.index("proactive")).any()
    assert got["mpc_used"].any()


def _snapshots():
    mu = np.array([2.0, 5.0])
    for i in range(8):
        lam0 = 3.0 + 1.5 * i  # a steady ramp the holt predictor locks onto
        yield i, np.array([lam0, lam0]), mu, lam0


def test_live_scheduler_proactive_matches_the_reference():
    """``DRSScheduler(proactive=)`` over the 8-tick ramp: the same actions,
    allocations, E[T] and reasons as the reference's, tick for tick."""
    names = ["extract", "match"]
    routing = np.array([[0.0, 1.0], [0.0, 0.0]])
    jcfg = jm.MPCConfig(horizon=3, window=8, min_scored=2,
                        predictor=jp.PredictorParams(kind="holt", alpha=0.6, beta=0.4))
    want_s = JaxScheduler(names, routing, np.array([2, 1]),
                          JaxConfig(k_max=32, t_max=2.0, tick_interval=10.0), proactive=jcfg)
    got_s = DRSScheduler(names, routing, np.array([2, 1]),
                         SchedulerConfig(k_max=32, t_max=2.0, tick_interval=10.0),
                         proactive=mpc_config_from_reference(jcfg))
    actions = []
    for i, lam, mu, lam0 in _snapshots():
        w = want_s.tick_from(JaxSnapshot.from_rates(lam, mu, lam0, 0.6, 10.0 * i), 10.0 * i)
        g = got_s.tick_from(MeasurementSnapshot.from_rates(lam, mu, lam0, 0.6, 10.0 * i),
                            10.0 * i)
        assert g.as_dict() == w.as_dict()
        np.testing.assert_array_equal(got_s.k_current, want_s.k_current)
        actions.append(g.action)
    assert "proactive" in actions
    np.testing.assert_array_equal(got_s._proactive.need, want_s._proactive.need)


def test_session_builds_a_proactive_scheduler():
    graph = AppGraph.chain([("a", 5.0), ("b", 9.0)], 2.0)
    session = DRSSession.bind(graph, "des", proactive=True)
    sched = session._build_scheduler(np.array([1, 1]))
    assert sched._proactive is not None and sched._proactive.cfg == tm.MPCConfig()


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _planner_rows(b, seed, dev):
    """The planner's kernel inputs at 3B rows: the peak rates repeated per
    candidate, budgets from the floor to past k_max, ``k_cur = 0``."""
    gen = torch.Generator().manual_seed(seed)
    n, k_hi = 7, 48
    mu = torch.rand(b, n, generator=gen, dtype=torch.float64) * 8.0 + 1.0
    lam = mu * torch.rand(b, n, generator=gen, dtype=torch.float64) * 5.0
    lam[::9, 0] = mu[::9, 0] * (k_hi + 3)  # a lane without a finite row
    group = torch.rand(b, n, generator=gen) < 0.2
    alpha = torch.where(group, 0.02, 0.0).double()
    lam = torch.where(group, torch.minimum(lam, 0.2 * mu / 0.02), lam)
    active = torch.ones(b, n, dtype=torch.bool)
    active[:, -1] = torch.rand(b, generator=gen) < 0.5

    def rep(x):
        return x.repeat_interleave(3, dim=0)

    floor = torch.where(active, torch.floor(lam / mu) + 1, 0.0).sum(-1)
    budgets = rep(floor).to(torch.int32) + torch.randint(-2, k_hi, (3 * b,), generator=gen,
                                                         dtype=torch.int32)
    budgets = torch.clamp(budgets, 0, k_hi)
    return dict(lam=rep(lam).float().to(dev), mu_eff=rep(mu).float().to(dev),
                group=rep(group).to(dev), alpha=rep(alpha).float().to(dev),
                active=rep(active).to(dev),
                k_cur=torch.zeros(3 * b, n, dtype=torch.int32, device=dev),
                k_max=budgets.to(dev)), k_hi


@pytest.mark.parametrize("b", [1, 256, 4096])
def test_cuda_decide_fused_as_the_planner_allocator_matches_plain(cuda_device, b):
    from repro_torch.kernels.decide_fused import kernel as dk

    d, k_hi = _planner_rows(b, 11, cuda_device)
    got = dk.batch_decide(**d, k_hi=k_hi, j_cap=k_hi)
    want = fused_ref.batch_decide(**d, k_hi=k_hi, j_cap=k_hi)
    for name, g, w in zip(("k4", "k_start", "t_cur", "t4"), got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy(), err_msg=name)


@pytest.mark.parametrize("b", [1, 256, 4096])
def test_cuda_gain_topr_at_the_planner_rows_matches_plain(cuda_device, b):
    from repro_torch.kernels.gain_topr import kernel as gk

    d, k_hi = _planner_rows(b, 12, cuda_device)
    T = tm.sojourn_table_arrays_torch(d["lam"], d["mu_eff"], d["group"], d["alpha"], k_hi)
    G = d["lam"][..., None] * (T[..., :-1] - T[..., 1:])
    cand = torch.where(torch.isfinite(G) & d["active"][..., None], G, 0.0).contiguous()
    budget = d["k_max"]
    np.testing.assert_array_equal(gk.gain_topr(cand, budget).cpu().numpy(),
                                  topr_ref.gain_topr(cand, budget).cpu().numpy())


@pytest.mark.parametrize("b", [1, 4096])
def test_cuda_mpc_erlang_table_matches_plain(cuda_device, b):
    """The planner's one Erlang-B launch over the flattened [B (H+1) N]
    loads, bitwise its plain version."""
    from repro_torch.kernels.erlang_c import kernel as ek

    gen = torch.Generator().manual_seed(b)
    a = (torch.rand(b * 4 * 7, generator=gen, dtype=torch.float64) * 30.0).float()
    a[::13] = 0.0
    got = ek.erlang_b_table(a.to(cuda_device), k_hi=48)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  erlang_ref.erlang_b_table(a, k_hi=48).numpy())


def test_cuda_proactive_compacted_loop_matches_the_cpu(cuda_device):
    """A 16-scenario zoo through the proactive compacted loop: card and CPU
    commit the same codes, allocations and plans; compacted and dense runs
    on the card agree bitwise."""
    port = [scenario_from_reference(s.with_(negotiated=False))
            for s in scenario_matrix(16, seed=11, horizon=20.0, warmup=5.0, dt=0.05)]

    def run(dev, compact):
        r = ScenarioRunner(port, tick_interval=5.0, proactive=True, compact=compact,
                           fused_decide=True, device=dev)
        r.run()
        return r.outputs

    cpu, card, dense = run("cpu", True), run(cuda_device, True), run(cuda_device, None)
    for key in ("codes", "k", "mpc_used"):
        np.testing.assert_array_equal(card[key], cpu[key], err_msg=key)
    for key in dense:
        np.testing.assert_array_equal(card[key], dense[key], err_msg=key)


def test_cuda_planner_prefix_sum_stays_within_its_bound(cuda_device):
    g = _sorted_gains(3, rows=4096)
    exact = np.cumsum(g.astype(np.float64), axis=-1)
    card = torch.cumsum(torch.from_numpy(g).to(cuda_device), dim=-1).cpu().numpy()
    assert float(np.max(np.abs(card - exact) / np.spacing(exact.astype(np.float32)))) \
        <= PREFIX_ULPS
