"""The window kernel's and the warp-route top-R selection's arithmetic, on
the CPU.

* ``queue_window``'s plain version (what the dispatch runs for CPU
  tensors) against a numpy float32 emulation of the CUDA window kernel's
  exact operation order (``csrc/queue_step.cu``): bitwise, over 100 steps,
  with padded lanes, ``+inf`` queues and a ``warm`` switch inside the
  window; and against the JAX package's ``window_step_fn`` at the
  tolerances of ``test_torch_modules``.
* The launch plans of both kernels.
* a numpy emulation of ``gain_topr_warp_kernel`` -- its register slots,
  the radix select, the ballot row counts and the tie scan -- against the
  sort-based plain version, exactly.

The CUDA kernels themselves run on a card (``test_torch_kernels.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.streaming.batchsim as jbs
from repro_torch.kernels.gain_topr import kernel as tgk, ref as tgr
from repro_torch.kernels.queue_step import kernel as tqk, ops as tqo, ref as tqr
from repro_torch.streaming import batchsim as tbs

F32 = np.float32


def window_case(b, n, steps, seed):
    """Scenarios of 1..n real lanes (the rest padded with zeros), sparse
    routing, ~half the queues bounded (the rest ``+inf``), service below
    the arrivals on some lanes (backlog and shedding), and a ``warm``
    weight switching from 0 to 1 a third of the way in."""
    rng = np.random.default_rng(seed)
    width = rng.integers(max(1, n - 3), n + 1, b)
    width[::5] = n
    lane = np.arange(n)[None, :] < width[:, None]
    pair = lane[:, :, None] & lane[:, None, :]
    routing = np.where(pair & (rng.random((b, n, n)) < 0.3),
                       rng.uniform(0.1, 1.1, (b, n, n)), 0.0)
    rate = rng.uniform(0.5, 8.0, (b, n))
    ext = np.where(lane, rng.poisson(rate, (steps, b, n)), 0).astype(np.float64)
    caps = np.where(lane, rng.uniform(0.5, 6.0, (b, n)) * rng.integers(1, 4, (b, n)), 0.0)
    capq = np.where(rng.random((b, n)) < 0.5, rng.integers(2, 30, (b, n)).astype(float), np.inf)
    capq = np.where(lane, capq, np.inf)
    q0 = np.where(lane, rng.uniform(0.0, 20.0, (b, n)), 0.0)
    sp0 = np.where(lane, rng.uniform(0.0, 3.0, (b, n)), 0.0)
    warm = (np.arange(steps) >= steps // 3).astype(np.float64)
    return q0, sp0, ext, warm, caps, capq, routing


def np_window(q, sp, ext, warm, caps, capq, routing):
    """The CUDA window kernel's operations, in its order, in float32: the
    routing product and the row sums left to right over the lanes, each
    product and sum rounded, ``acc + w * x`` as a product then a sum."""
    b, n = q.shape
    z = np.zeros((b, n), F32)
    zb = np.zeros(b, F32)
    off, srv, drop_s, qint, qmax = z.copy(), z.copy(), z.copy(), z.copy(), z.copy()
    woff, wsrv, wdrop, wqi = z.copy(), z.copy(), z.copy(), z.copy()
    ea, eo, wea, weo = zb.copy(), zb.copy(), zb.copy(), zb.copy()
    with np.errstate(all="ignore"):
        for t in range(ext.shape[0]):
            e, w = ext[t], warm[t]
            routed = sp[:, 0, None] * routing[:, 0, :]
            for i in range(1, n):
                routed = routed + sp[:, i, None] * routing[:, i, :]
            inflow = e + routed
            served = np.minimum(q, caps)
            q1 = q - served
            adm = np.minimum(inflow, np.maximum(capq - q1, F32(0)))
            q = q1 + adm
            drop = inflow - adm
            frac = np.where(inflow > 0, (inflow - drop) / inflow, F32(1))
            x = e * frac
            ea_t, eo_t = x[:, 0], e[:, 0]
            for i in range(1, n):
                ea_t = ea_t + x[:, i]
                eo_t = eo_t + e[:, i]
            off, srv, drop_s, qint = off + inflow, srv + served, drop_s + drop, qint + q
            qmax = np.maximum(qmax, q)
            woff, wsrv = woff + w * inflow, wsrv + w * served
            wdrop, wqi = wdrop + w * drop, wqi + w * q
            ea, eo, wea, weo = ea + ea_t, eo + eo_t, wea + w * ea_t, weo + w * eo_t
            sp = served
    return (q, sp, off, srv, drop_s, ea, eo, qint, qmax, woff, wsrv, wdrop, wea, weo, wqi)


def _t(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("b,n,seed", [(64, 7, 0), (64, 7, 1), (16, 40, 2), (33, 1, 3)])
def test_plain_window_equals_kernel_order_emulation_bitwise(b, n, seed):
    case = window_case(b, n, 100, seed)
    f32 = [x.astype(F32) for x in case]
    got = tqo.queue_window(*(_t(x) for x in f32))
    want = np_window(*f32)
    assert len(got) == len(want) == 15
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"output {i}")
    q0, _sp0, _ext, _warm, _caps, capq, _r = case
    assert np.isinf(capq).any() and (got[4].numpy()[np.isinf(capq)] == 0).all()
    assert (got[4].numpy() > 0).any(), "some bounded queue must shed"
    assert (got[9].numpy() < got[2].numpy()).any(), "warm must gate part of the window"


def matrix_window_case(seed, steps=100):
    """A window of the reference's own scenario matrix (its routing is
    acyclic), as ``test_torch_modules`` builds it."""
    from repro.streaming import scenarios as jsc

    scens = [s.with_(negotiated=False) for s in
             jsc.scenario_matrix(6, seed=seed, horizon=steps * 0.05, warmup=0.5, dt=0.05)]
    a = jsc.pack_scenarios(scens)
    rng = np.random.default_rng(seed)
    k = np.where(a.active, rng.integers(1, 4, a.mu.shape), 0)
    caps = jbs.service_capacity(k, a.mu, a.group, a.alpha) * a.dt
    q0 = np.where(a.active, rng.uniform(0.0, 5.0, a.mu.shape), 0.0)
    sp0 = np.where(a.active, rng.uniform(0.0, 2.0, a.mu.shape), 0.0)
    warm = (np.arange(steps) >= steps // 3).astype(np.float64)
    return q0, sp0, a.ext[:steps], warm, caps, a.cap_queue, a.routing


@pytest.mark.parametrize("x64", [True, False])
@pytest.mark.parametrize("case_of", ["synthetic", "matrix-6", "matrix-7"])
def test_ordered_plain_window_matches_jax_window(x64, case_of):
    """The same tolerances as ``test_window_step_matches_jax_window``:
    rtol 1e-13 in float64, 2e-6 in float32 (XLA contracts the routing
    product's multiply-adds; the port rounds every product).  Dense cyclic
    routing (``window_case`` at N 40) amplifies that one-rounding
    difference past 2e-6 within 100 steps; there the plain window is held
    bitwise to the kernel's order instead (above)."""
    if case_of == "synthetic":
        case = window_case(24, 7, 100, 4)
    else:
        case = matrix_window_case(int(case_of.split("-")[1]))
    dtype = torch.float64 if x64 else torch.float32
    q0, sp0, ext, warm, caps, capq, routing = case
    got = tbs.window_step_fn()(_t(q0, dtype), _t(sp0, dtype), _t(ext, dtype), warm,
                               _t(caps, dtype), _t(capq, dtype), _t(routing, dtype))
    with jax.enable_x64(x64):
        want = [np.asarray(w) for w in jbs.window_step_fn()(*(jnp.asarray(x) for x in case))]
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-13 if x64 else 2e-6,
                                   atol=1e-13 if x64 else 1e-6, err_msg=f"output {i}")


def test_window_takes_warm_as_a_tensor_or_a_host_sequence():
    f32 = [x.astype(F32) for x in window_case(8, 5, 12, 6)]
    args = [_t(x) for x in f32]
    as_tensor = tqr.queue_window(*args)
    args[3] = f32[3].tolist()
    for g, w in zip(tqr.queue_window(*args), as_tensor):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n,route,width", [
    (1, "segment", 8), (2, "segment", 8), (3, "segment", 8), (7, "segment", 8),
    (8, "segment", 8), (9, "segment", 32), (16, "segment", 32), (17, "segment", 32),
    (32, "segment", 32), (33, "wide", 64), (40, "wide", 64), (64, "wide", 64),
    (65, "wide", 96),
])
def test_queue_window_plan_routes_by_width(n, route, width):
    """Segments of 8 lanes up to N = 8 and of 32 up to N = 32, a block per
    scenario (whole warps of lanes) past it."""
    assert tqk.plan(n) == (route, width)


def test_queue_window_plan_refuses_no_lanes():
    with pytest.raises(ValueError, match="N must be >= 1"):
        tqk.plan(0)


# --------------------------------------------------------------------------- #
# gain_topr's warp route, emulated
# --------------------------------------------------------------------------- #
def _lane_range(a, bnd):
    a, bnd = max(a, 0), min(bnd, 32)
    return 0 if bnd <= a else ((1 << bnd) - 1) & ~((1 << a) - 1)


def _slot_lanes(s, lo, hi):
    """The kernel's lane mask of the slot ``s`` elements (index 32 s +
    lane) in [lo, hi)."""
    return _lane_range(lo - 32 * s, hi - 32 * s)


def _bits(v):
    return np.asarray(v, F32).view(np.int32).astype(np.int64)


def _radix(vals, need):
    u = _bits(vals[vals > 0])
    prefix = 0
    for rnd in range(4):
        shift = 24 - 8 * rnd
        match = u if rnd == 0 else u[(u >> (shift + 8)) == (prefix >> (shift + 8))]
        hist = np.bincount((match >> shift) & 255, minlength=256)
        above = 0
        for bin_ in range(255, -1, -1):
            if above + hist[bin_] >= need:
                need -= above
                prefix |= bin_ << shift
                break
            above += hist[bin_]
    return np.array([prefix], np.int32).view(F32)[0]


def warp_topr(cand, budget):
    """``gain_topr_warp_kernel`` in numpy, scenario by scenario."""
    b, n, j = cand.shape
    e = n * j
    _route, slots = tgk.plan(n, j)
    take = np.zeros((b, n), np.int32)
    for sc in range(b):
        flat = cand[sc].reshape(-1)
        v = np.zeros((slots, 32), F32)  # [slot, lane]
        for s in range(slots):
            for lane in range(32):
                i = 32 * s + lane
                x = flat[i] if i < e else F32(0)
                v[s, lane] = x if x > 0 else F32(0)
        bud = int(budget[sc])
        total = int((v > 0).sum())
        use_all = total <= bud
        thresh = np.float32(np.inf)
        if bud > 0 and not use_all:
            thresh = _radix(v.reshape(-1), bud)
        strict, ties, pos = (np.zeros(32, np.int64) for _ in range(3))
        for s in range(slots):
            ballot = {k: sum(1 << lane for lane in range(32) if p(v[s, lane]))
                      for k, p in (("pos", lambda x: x > 0),
                                   ("strict", lambda x: x > 0 and x > thresh),
                                   ("tie", lambda x: x > 0 and x == thresh))}
            for r in range(n):
                row = _slot_lanes(s, r * j, r * j + j)
                pos[r] += bin(ballot["pos"] & row).count("1")
                strict[r] += bin(ballot["strict"] & row).count("1")
                ties[r] += bin(ballot["tie"] & row).count("1")
        before = np.cumsum(ties) - ties
        rem = bud - strict.sum()
        extra = np.maximum(np.minimum(ties, rem - before), 0)
        tk = pos if use_all else strict + extra
        take[sc] = (tk[:n] if bud > 0 else 0)
    return take


def topr_case(b, n, j, seed):
    """Non-increasing rows of quantized gains (many ties) with a padded
    operator, padded columns, negative and NaN entries, +inf gains, and
    budgets of 0, below 0, exactly the positives, past them, and random."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 9, (b, n, j)).astype(F32) * F32(0.5)
    cand = -np.sort(-raw, axis=-1)
    if n > 1:
        cand[:, -1, :] = 0.0
    cand[:, :, j - max(1, j // 6):] = 0.0
    cand[1::3, 0, 0] = np.inf
    cand[2::5, n // 2, -1] = -1.5
    cand[4::7, 0, -1] = np.nan
    pos = (cand > 0).sum(axis=(1, 2))
    budget = rng.integers(1, max(2, int(pos.max()) + 1), b).astype(np.int32)
    budget[0::6] = 0
    budget[1::6] = pos[1::6]
    budget[2::6] = pos[2::6] + 4
    budget[3::6] = -2
    budget[4::6] = np.maximum(pos[4::6] - 1, 1)
    return cand, budget


@pytest.mark.parametrize("n,j,seed", [
    (7, 48, 0), (7, 48, 1), (3, 5, 2), (5, 13, 3), (32, 16, 4), (16, 32, 5), (1, 1, 6),
    (31, 3, 7), (7, 48, 11), (7, 48, 12), (7, 47, 13), (2, 64, 14), (4, 33, 15),
    (8, 64, 16), (32, 1, 17), (11, 29, 18),
])
def test_warp_topr_emulation_equals_sorted_plain(n, j, seed):
    """The fleet tile over several seeds, N J not a multiple of 32, and up
    to the warp route's edge (32 x 16 = 512 gains)."""
    cand, budget = topr_case(12, n, j, seed)
    assert tgk.plan(n, j)[0] == "warp"
    want = tgr.gain_topr(_t(cand), _t(budget)).numpy()
    np.testing.assert_array_equal(warp_topr(cand, budget), want)


@pytest.mark.parametrize("seed", [8, 9, 10])
def test_radix_select_finds_the_budget_th_largest(seed):
    """The budget-th largest positive value, +inf and subnormals included,
    as the sorted values give it."""
    rng = np.random.default_rng(seed)
    vals = np.concatenate([rng.choice(np.array([0.25, 0.5, 3.0, np.inf], F32), 40),
                           rng.uniform(0, 1e-38, 20).astype(F32),
                           rng.lognormal(0, 8, 60).astype(F32)])
    pos = np.sort(vals[vals > 0])[::-1]
    for need in range(1, len(pos) + 1):
        assert _radix(vals, need) == pos[need - 1]


@pytest.mark.parametrize("n,j,route,slots", [
    (7, 48, "warp", 12), (1, 1, "warp", 4), (4, 32, "warp", 4), (4, 33, "warp", 8),
    (32, 16, "warp", 16), (16, 32, "warp", 16), (32, 17, "block", 0), (33, 2, "block", 0),
    (8, 65, "block", 0), (7, 0, "warp", 4),
])
def test_gain_topr_plan_routes_by_tile(n, j, route, slots):
    """The warp route holds 4 ceil(N J / 128) values per lane, up to 16 (N J
    <= 512) and N <= 32; larger tiles take the block route."""
    assert tgk.plan(n, j) == (route, slots)
