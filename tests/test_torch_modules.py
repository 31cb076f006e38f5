"""The port's modules against the JAX package on the same inputs: the
spec layer (scenario matrix, packing, allocation), the analytic core, the
batch simulator's window and the batched decide."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.batched as jb
import repro.core.controller as jctl
import repro.streaming.batchsim as jbs
from repro.api.session import ScenarioRunner as JaxRunner
from repro.streaming import scenarios as jsc
from repro_torch.convert import from_reference, scenario_from_reference
from repro_torch.core import batched as tb, controller as tctl
from repro_torch.streaming import batchsim as tbs, scenarios as tsc


def _t(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t if dtype is None else t.to(dtype)


# --------------------------------------------------------------------------- #
# spec layer: the port's own numpy copies give the reference's scenarios
# --------------------------------------------------------------------------- #
def test_scenario_matrix_and_packing_match_reference():
    ref = jsc.scenario_matrix(12, seed=3, horizon=20.0, warmup=5.0, dt=0.05)
    got = tsc.scenario_matrix(12, seed=3, horizon=20.0, warmup=5.0, dt=0.05)
    for r, g in zip(ref, got):
        assert (g.name, g.seed, g.t_max, g.queue_capacity, g.allocator, g.negotiated) == (
            r.name, r.seed, r.t_max, r.queue_capacity, r.allocator, r.negotiated)
        np.testing.assert_array_equal(g.graph.routing_matrix(), r.graph.routing_matrix())
        np.testing.assert_array_equal(g.plan_k0(), r.plan_k0())
    ra, ga = jsc.pack_scenarios(ref), tsc.pack_scenarios(got)
    for name in ("ext", "routing", "mu", "group", "alpha", "cap_queue", "active", "ca2", "cs2"):
        np.testing.assert_array_equal(getattr(ga, name), getattr(ra, name), err_msg=name)
    assert (ga.dt, ga.warmup_steps) == (ra.dt, ra.warmup_steps)
    # The converter rebuilds the same scenarios from the reference objects.
    conv = [scenario_from_reference(r) for r in ref]
    np.testing.assert_array_equal(tsc.pack_scenarios(conv).ext, ra.ext)


# --------------------------------------------------------------------------- #
# analytic core
# --------------------------------------------------------------------------- #
def _lanes(seed=0, s=40):
    rng = np.random.default_rng(seed)
    mu = rng.uniform(1.0, 9.0, s)
    lam = mu * rng.integers(1, 6, s) * rng.uniform(0.05, 0.95, s)
    lam[::9] = 0.0
    group = rng.random(s) < 0.3
    alpha = np.where(group, 0.03, 0.0)
    min_k = rng.integers(1, 3, s)
    return lam, mu, group, alpha, min_k


def test_sojourn_table_torch_matches_numpy_f64_and_jax_f32():
    from repro.core.jackson import OperatorSpec, Topology

    lam, mu, group, alpha, min_k = _lanes()
    k_hi = 60
    got = tb.sojourn_table_torch(_t(lam), _t(mu), k_hi=k_hi, group=_t(group),
                                 alpha=_t(alpha), min_k=_t(min_k))
    # numpy float64 twin: one isolated operator per lane (lam0 = lam)
    ops = [OperatorSpec(f"o{i}", float(mu[i]), "group" if group[i] else "replica",
                        float(alpha[i]), int(min_k[i])) for i in range(len(lam))]
    want = jb.sojourn_table(Topology(ops, lam, np.zeros((len(lam),) * 2)), k_hi)
    np.testing.assert_array_equal(np.isfinite(got.numpy()), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[fin], want[fin], rtol=1e-9, atol=0)
    f32 = [x.astype(np.float32) if x.dtype.kind == "f" else x for x in (lam, mu, alpha)]
    got32 = tb.sojourn_table_torch(_t(f32[0]), _t(f32[1]), k_hi=k_hi, group=_t(group),
                                   alpha=_t(f32[2]), min_k=_t(min_k)).numpy()
    want32 = np.asarray(jb.sojourn_table_jax(
        jnp.asarray(f32[0]), jnp.asarray(f32[1]), k_hi=k_hi, group=group,
        alpha=jnp.asarray(f32[2]), min_k=min_k))
    np.testing.assert_array_equal(np.isfinite(got32), np.isfinite(want32))
    fin = np.isfinite(want32)
    np.testing.assert_allclose(got32[fin], want32[fin], rtol=1e-6, atol=0)


def test_solve_traffic_batch_torch_matches_numpy_f64_and_jax_f32():
    scens = jsc.scenario_matrix(10, seed=8, horizon=10.0)
    arrays = jsc.pack_scenarios(scens)
    rng = np.random.default_rng(1)
    lam0 = np.where(arrays.active, rng.uniform(0.0, 20.0, arrays.mu.shape), 0.0)
    want = jb.solve_traffic_batch(lam0, arrays.routing)
    got = tb.solve_traffic_batch_torch(_t(lam0), _t(arrays.routing)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    got32 = tb.solve_traffic_batch_torch(_t(lam0, torch.float32),
                                         _t(arrays.routing, torch.float32)).numpy()
    want32 = np.asarray(jb.solve_traffic_batch_jax(jnp.asarray(lam0, jnp.float32),
                                                   jnp.asarray(arrays.routing, jnp.float32)))
    np.testing.assert_allclose(got32, want32, rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------- #
# batch simulator window
# --------------------------------------------------------------------------- #
def _window_case(seed=2, steps=40):
    scens = [s.with_(negotiated=False) for s in
             jsc.scenario_matrix(6, seed=seed, horizon=steps * 0.05, warmup=0.5, dt=0.05)]
    a = jsc.pack_scenarios(scens)
    rng = np.random.default_rng(seed)
    k = np.where(a.active, rng.integers(1, 4, a.mu.shape), 0)
    cap_serve_dt = jbs.service_capacity(k, a.mu, a.group, a.alpha) * a.dt
    q0 = np.where(a.active, rng.uniform(0.0, 5.0, a.mu.shape), 0.0)
    sp0 = np.where(a.active, rng.uniform(0.0, 2.0, a.mu.shape), 0.0)
    warm = (np.arange(steps) >= steps // 3).astype(np.float64)
    return q0, sp0, a.ext[:steps], warm, cap_serve_dt, a.cap_queue, a.routing


def test_jax_routing_product_is_an_fma_chain_in_float32():
    """Why the float32 window comparison below needs 2e-6: XLA's CPU
    backend evaluates ``einsum("bi,bij->bj")`` in float32 as a fused
    multiply-add chain over i (one rounding per term -- emulated here
    exactly in float64), while the port's batched product rounds every
    product before adding it."""
    rng = np.random.default_rng(0)
    sp = rng.uniform(0, 5, (500, 7)).astype(np.float32)
    r = np.where(rng.random((500, 7, 7)) < 0.4, rng.uniform(0.1, 1.2, (500, 7, 7)), 0.0)
    r = r.astype(np.float32)
    want = np.asarray(jnp.einsum("bi,bij->bj", sp, r))
    acc = np.zeros((500, 7), np.float32)
    for i in range(7):
        acc = (acc.astype(np.float64) + sp[:, i, None].astype(np.float64)
               * r[:, i, :].astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(acc, want)


@pytest.mark.parametrize("x64", [True, False])
@pytest.mark.parametrize("seed", [2, 3])
def test_window_step_matches_jax_window(x64, seed):
    """All 15 outputs of a 100-step window: rtol 1e-13 in float64, 2e-6 in
    float32.  XLA's dot contracts the routing product's multiply-adds
    (above; in float64 too, where the window differs by an ulp on some
    lanes), the port rounds each product, and the backlog carries each
    ulp-level difference from step to step: the backlog sums drift by up to
    ~12 ulp in float32 (1.4e-6 measured on seed 2)."""
    case = _window_case(seed=seed, steps=100)
    dtype = torch.float64 if x64 else torch.float32
    q0, sp0, ext, warm, caps, capq, routing = case
    got = tbs.window_step_fn()(_t(q0, dtype), _t(sp0, dtype), _t(ext, dtype), warm,
                               _t(caps, dtype), _t(capq, dtype), _t(routing, dtype))
    with jax.enable_x64(x64):
        want = jbs.window_step_fn()(*(jnp.asarray(x) for x in case))
        want = [np.asarray(w) for w in want]
    assert len(got) == len(want) == 15
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-13 if x64 else 2e-6,
                                   atol=1e-13 if x64 else 1e-6, err_msg=f"output {i}")


# --------------------------------------------------------------------------- #
# the batched decide on real window measurements
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def decide_case():
    """A 32-scenario non-negotiated matrix, stepped two windows on the
    reference's numpy twin; each window's measurement is a decide input."""
    scens = [s.with_(negotiated=False)
             for s in jsc.scenario_matrix(32, seed=21, horizon=20.0, warmup=5.0, dt=0.05)]
    runner = JaxRunner(scens, tick_interval=5.0, backend="numpy", fused=False)
    inputs = []
    for _ in range(2):
        w = runner.sim.step_window(runner.k, runner._steps_per_tick)
        meas, _ = runner._window_measurement(w)
        inputs.append((meas.lam_hat, meas.mu_hat, meas.drop_hat, meas.lam0_hat,
                       runner.k.copy()))
        runner.k = np.maximum(runner.k - 1, np.where(runner.static.active, 1, 0))
    arr, st, pr, _ = from_reference(runner.arrays, runner.static, runner._params(),
                                    runner.k, device="cpu")
    return runner, st, pr, inputs


@pytest.mark.parametrize("x64", [True, False])
def test_decide_matches_make_decide_jax(decide_case, x64):
    """Codes, ``k_next`` and the apply mask bitwise; ``et_cur`` /
    ``et_target`` within rel 1e-9 (float64) or 1e-5 (float32) on every
    lane the decide finds feasible.  In float32 the two LAPACK builds'
    traffic solves differ by a few ulp and E[T] amplifies a lane's rate
    error by up to 1/(1 - rho) near saturation (4.8e-6 measured across
    three 32-scenario matrices).  An infeasible lane's E[T] is a
    diagnostic of a traffic solve that may be numerically singular: the
    offered-load rescale can close a routing loop at spectral radius 1
    (condition number ~2e16 on one lane of this case), and then the
    solution is rounding noise that differs between LAPACK builds -- the
    JAX package gets large negative rates there, PyTorch large positive
    ones, and both call the lane infeasible."""
    runner, st, pr, inputs = decide_case
    dtype = torch.float64 if x64 else torch.float32
    infeasible = tctl.ACTIONS.index("infeasible")
    codes = set()
    for fused in (False, True):
        port = tctl.make_decide(st, pr, fused=fused, device="cpu", dtype=dtype)
        with jax.enable_x64(x64):
            ref = jctl.make_decide_jax(runner.static, runner._params(), fused=fused)
            for lam, mu, drop, lam0, k in inputs:
                got = port(lam, mu, drop, lam0, k)
                want = [np.asarray(w) for w in ref(lam, mu, drop, lam0, k)]
                for name, i in (("code", 0), ("k_next", 1), ("applied", 4)):
                    np.testing.assert_array_equal(got[i].numpy(), want[i], err_msg=name)
                feasible = want[0] != infeasible
                for name, i in (("et_cur", 2), ("et_target", 3)):
                    np.testing.assert_allclose(
                        got[i].numpy()[feasible], want[i][feasible],
                        rtol=1e-9 if x64 else 1e-5, err_msg=name)
                codes.update(got[0].tolist())
    assert len(codes) >= 2, "the windows should exercise more than one action"


def test_decide_fused_and_two_pass_agree_bitwise(decide_case):
    _, st, pr, inputs = decide_case
    for dtype in (torch.float32, torch.float64):
        two = tctl.make_decide(st, pr, fused=False, device="cpu", dtype=dtype)
        one = tctl.make_decide(st, pr, fused=True, device="cpu", dtype=dtype)
        for args in inputs:
            for a, b in zip(two(*args), one(*args)):
                assert torch.equal(a, b)
