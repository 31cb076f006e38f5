"""The port's four control-loop kernels against the JAX package.

Each plain PyTorch version (``repro_torch/kernels/*/ref.py``, what the
dispatch runs for CPU tensors) is held against the JAX package's jnp
reference and against its Pallas kernel in interpret mode, on the same
seeded numpy inputs.  The CUDA kernels themselves run only on a card:
``test_cuda_kernels_match_plain_versions`` skips without one (the whole
check also runs in ``chip_smoke.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decide_fused import kernel as jdk, ref as jdr
from repro.kernels.erlang_c import kernel as jek, ref as jer
from repro.kernels.gain_topr import kernel as jgk, ref as jgr
from repro.kernels.queue_step import kernel as jqk, ref as jqr
from repro_torch.kernels import _build
from repro_torch.kernels.decide_fused import kernel as tdk, ops as tdo, ref as tdr
from repro_torch.kernels.erlang_c import kernel as tek, ops as teo, ref as ter
from repro_torch.kernels.gain_topr import kernel as tgk, ops as tgo, ref as tgr
from repro_torch.kernels.queue_step import kernel as tqk, ops as tqo, ref as tqr


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _bitwise(got, want, name=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=name)


def _bitwise_ftz(got, want, name=""):
    """Bitwise equality after flushing ``got``'s subnormals to zero.

    XLA's CPU backend runs with flush-to-zero, so where the Erlang-B
    recurrence underflows below the smallest normal float the JAX table
    holds 0 and PyTorch (like the CUDA kernel) keeps the subnormal.  Every
    normal entry must match bit for bit; the subnormal ones differ by less
    than the smallest normal float (1.2e-38 in float32).
    """
    got = np.asarray(got)
    tiny = np.finfo(got.dtype).tiny
    flushed = np.where(np.abs(got) < tiny, np.zeros_like(got), got)
    np.testing.assert_array_equal(flushed, np.asarray(want), err_msg=name)


# --------------------------------------------------------------------------- #
# queue_step
# --------------------------------------------------------------------------- #
def _queue_case(m=300, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.uniform(0.0, 40.0, m)
    q[::7] = 0.0
    inflow = rng.poisson(3.0, m).astype(np.float64)
    cap_s = rng.uniform(0.0, 10.0, m)
    cap_s[1::11] = q[1::11]
    cap_q = np.where(rng.random(m) < 0.4, rng.integers(5, 60, m).astype(np.float64), np.inf)
    return q, inflow, cap_s, cap_q


def test_queue_step_plain_matches_jax_bitwise_f32():
    case = [x.astype(np.float32) for x in _queue_case()]
    got = tqr.queue_step(*map(_t, case))
    want = jqr.queue_step(*map(jnp.asarray, case))
    pallas = jqk.queue_step_pallas(*map(jnp.asarray, case), interpret=True)
    for i, (g, w, p) in enumerate(zip(got, want, pallas)):
        _bitwise(g, w, f"ref out {i}")
        _bitwise(g, p, f"pallas out {i}")
    assert np.isinf(case[3]).any() and (np.asarray(got[2])[np.isinf(case[3])] == 0).all()


def test_queue_step_plain_matches_jax_ref_f64():
    case = _queue_case(seed=1)
    got = tqr.queue_step(*map(_t, case))
    with jax.enable_x64(True):
        want = jqr.queue_step(*map(jnp.asarray, case))
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == torch.float64
            _bitwise(g, w, f"out {i}")


# --------------------------------------------------------------------------- #
# erlang_c
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("k_hi", [1, 50, 300])
def test_erlang_b_plain_matches_jax_bitwise_f32(k_hi):
    a = np.abs(np.random.default_rng(k_hi).normal(6.0, 5.0, 130)).astype(np.float32)
    a[0] = 0.0
    got = ter.erlang_b_table(_t(a), k_hi=k_hi)
    assert got.shape == (k_hi + 1, 130) and got.dtype == torch.float32
    _bitwise_ftz(got, jer.erlang_b_table(jnp.asarray(a), k_hi=k_hi), "ref")
    _bitwise_ftz(got, jek.erlang_b_table_pallas(jnp.asarray(a), k_hi=k_hi, interpret=True),
                 "pallas")


def test_erlang_b_plain_matches_jax_ref_f64():
    a = np.abs(np.random.default_rng(3).normal(40.0, 30.0, 64))
    got = ter.erlang_b_table(_t(a), k_hi=512)
    with jax.enable_x64(True):
        _bitwise_ftz(got, jer.erlang_b_table(jnp.asarray(a), k_hi=512))


# --------------------------------------------------------------------------- #
# gain_topr
# --------------------------------------------------------------------------- #
def _topr_case(b=24, n=7, j=20, seed=0):
    """Non-increasing quantized rows (many threshold ties), zero-padded
    operator lanes and gain columns, budgets of 0, exactly the positives,
    and more than the positives."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 9, (b, n, j)).astype(np.float32) * 0.5
    cand = -np.sort(-raw, axis=-1)
    cand[:, -2:, :] = 0.0  # padded operators
    cand[:, :, -3:] = 0.0  # padded gain columns
    pos = (cand > 0).sum(axis=(1, 2))
    budget = rng.integers(0, 60, b).astype(np.int32)
    budget[0::4] = 0
    budget[1::4] = pos[1::4]
    budget[2::4] = pos[2::4] + 5
    return cand, budget


@pytest.mark.parametrize("seed", [0, 1])
def test_gain_topr_plain_matches_jax_exactly(seed):
    cand, budget = _topr_case(seed=seed)
    got = tgr.gain_topr(_t(cand), _t(budget))
    assert got.dtype == torch.int32
    _bitwise(got, jgr.gain_topr(jnp.asarray(cand), jnp.asarray(budget)), "ref")
    _bitwise(got, jgk.gain_topr_pallas(jnp.asarray(cand), jnp.asarray(budget),
                                       interpret=True), "pallas")
    assert (got.sum(-1).numpy() <= np.maximum(budget, 0)).all()


def test_gain_topr_ties_go_in_operator_order():
    cand = np.zeros((1, 3, 4), np.float32)
    cand[0, :, :2] = 1.0  # six equal gains
    got = tgr.gain_topr(_t(cand), _t(np.array([5], np.int32)))
    _bitwise(got, [[2, 2, 1]])


# --------------------------------------------------------------------------- #
# decide_fused
# --------------------------------------------------------------------------- #
def _decide_case(seeds=(6, 7, 8), extra_budget=24):
    """Zoo topologies stacked into a padded [B, N] batch, some lanes gang
    scaled, plus an infeasible lane and a zero-budget scenario."""
    from repro.streaming.scenarios import random_appgraph

    tops = [random_appgraph(s).topology() for s in seeds]
    b, n = len(tops), max(t.n for t in tops)
    lam, mu = np.zeros((b, n)), np.ones((b, n))
    group, alpha = np.zeros((b, n), bool), np.zeros((b, n))
    active = np.zeros((b, n), bool)
    rng = np.random.default_rng(seeds[0])
    for i, top in enumerate(tops):
        lam[i, : top.n] = top.arrival_rates
        mu[i, : top.n] = [op.mu for op in top.operators]
        active[i, : top.n] = top.arrival_rates > 0
        for lane in range(top.n):
            if rng.random() < 0.3 and lam[i, lane] < 0.2 * mu[i, lane] / 0.02:
                group[i, lane], alpha[i, lane] = True, 0.02
    k_cur = rng.integers(0, 6, size=(b, n)).astype(np.int32)
    floor = np.where(active, np.floor(lam / mu) + 1, 0).sum(axis=1)
    k_max = (floor + extra_budget).astype(np.int32)
    k_max[-1] = 0
    lam[0, 0] = mu[0, 0] * 600.0  # no finite row up to k_hi = 512: infeasible
    return lam, mu, group, alpha, active, k_cur, k_max


def _run(fn, case, k_hi, wrap, **kw):
    lam, mu, group, alpha, active, k_cur, k_max = (wrap(x) for x in case)
    return fn(lam, mu, group=group, alpha=alpha, active=active, k_cur=k_cur,
              k_max=k_max, k_hi=k_hi, **kw)


@pytest.mark.parametrize("k_hi,j_cap", [(64, None), (200, 48)])
def test_batch_decide_plain_matches_jax_f32(k_hi, j_cap):
    case = tuple(x.astype(np.float32) if x.dtype.kind == "f" else x
                 for x in _decide_case())
    got = _run(tdr.batch_decide, case, k_hi, _t, j_cap=j_cap)
    want = _run(jdr.batch_decide, case, k_hi, jnp.asarray, j_cap=j_cap)
    assert (np.asarray(got[1]) == k_hi + 1).any(), "case must hold an infeasible lane"
    for name, g, w in zip(("k4", "k_start", "t_cur", "t4"), got, want):
        _bitwise(g, w, name)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max(initial=0))


@pytest.mark.parametrize("seeds,k_hi,j_cap", [((9, 10), 64, None), ((1, 2, 3, 4), 200, 48)])
def test_batch_decide_plain_matches_pallas_interpret(seeds, k_hi, j_cap):
    """Integer outputs exact; T gathers within 32 ulp.

    The interpret-mode kernel evaluates the table inside an XLA loop body,
    where XLA's CPU backend contracts multiply-adds into FMAs (the JAX
    package's own kernel test allows rtol 1e-4 against its jnp reference
    for the same reason), and near a lane's stability edge ``k*mu - lam``
    cancels, amplifying that one rounding.  The plain version and the CUDA
    kernel (built with -fmad=false) round every op separately, as the jnp
    reference does: both match that reference bitwise (the test above).
    """
    case = tuple(x.astype(np.float32) if x.dtype.kind == "f" else x
                 for x in _decide_case(seeds))
    got = _run(tdr.batch_decide, case, k_hi, _t, j_cap=j_cap)
    lam, mu, group, alpha, active, k_cur, k_max = map(jnp.asarray, case)
    want = jdk.batch_decide_pallas(lam, mu, group, alpha, active, k_cur, k_max,
                                   k_hi=k_hi, j_cap=j_cap, interpret=True)
    _bitwise(got[0], want[0], "k4")
    _bitwise(got[1], want[1], "k_start")
    for name, g, w in zip(("t_cur", "t4"), got[2:], want[2:]):
        g, w = np.asarray(g), np.asarray(w)
        _bitwise(np.isfinite(g), np.isfinite(w), name)
        fin = np.isfinite(g)
        assert _ulps(g[fin], w[fin]) <= 32, name


def test_batch_decide_plain_matches_numpy_twin_f64():
    case = _decide_case((11, 12, 13))
    got = _run(tdr.batch_decide, case, 128, _t, j_cap=48)
    want = _run(jdr.batch_decide_np, case, 128, np.asarray, j_cap=48)
    for name, g, w in zip(("k4", "k_start"), got[:2], want[:2]):
        _bitwise(g, w, name)
    for name, g, w in zip(("t_cur", "t4"), got[2:], want[2:]):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-9, atol=0, err_msg=name)


# --------------------------------------------------------------------------- #
# dispatch + wrapper contract
# --------------------------------------------------------------------------- #
def test_ops_send_cpu_tensors_to_the_plain_versions():
    before = dict(_build.LAUNCHES)
    q = _t(np.ones(4, np.float32))
    for g, w in zip(tqo.queue_step(q, q, q, q), tqr.queue_step(q, q, q, q)):
        _bitwise(g, w)
    a = _t(np.array([0.5, 2.0], np.float32))
    _bitwise(teo.erlang_b_table(a, k_hi=3), ter.erlang_b_table(a, k_hi=3))
    cand, budget = _topr_case(b=4)
    _bitwise(tgo.gain_topr(_t(cand), _t(budget)), tgr.gain_topr(_t(cand), _t(budget)))
    case = _decide_case((14, 15))
    for g, w in zip(_run(tdo.batch_decide, case, 32, _t), _run(tdr.batch_decide, case, 32, _t)):
        _bitwise(g, w)
    assert dict(_build.LAUNCHES) == before  # no kernel launch on the CPU


@pytest.mark.parametrize("call", [
    lambda x: tqk.queue_step(x, x, x, x),
    lambda x: tqk.queue_window(x.reshape(2, 2), x.reshape(2, 2), x.reshape(1, 2, 2), x[:1],
                               x.reshape(2, 2), x.reshape(2, 2), torch.ones(2, 2, 2)),
    lambda x: tek.erlang_b_table(x, k_hi=4),
    lambda x: tgk.gain_topr(x.reshape(1, 2, 2), torch.zeros(1, dtype=torch.int32)),
    lambda x: tdk.batch_decide(
        x.reshape(2, 2), x.reshape(2, 2), group=torch.zeros(2, 2, dtype=torch.bool),
        alpha=x.reshape(2, 2), active=torch.ones(2, 2, dtype=torch.bool),
        k_cur=torch.zeros(2, 2, dtype=torch.int32),
        k_max=torch.ones(2, dtype=torch.int32), k_hi=4),
])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    with pytest.raises(ValueError, match="CUDA"):
        call(torch.ones(4, dtype=torch.float32))


@pytest.mark.parametrize("n,width,threads", [
    (1, 8, 32), (2, 8, 32), (3, 8, 32), (7, 8, 32), (8, 8, 32), (9, 32, 32), (16, 32, 32),
    (17, 32, 32), (32, 32, 32), (33, 0, 64), (64, 0, 64), (65, 0, 96),
])
def test_decide_plan_packs_scenarios_by_segment_width(n, width, threads):
    """N <= 32: segments of 8 lanes up to N = 8, else 32, one warp of
    32 // width scenarios per block and a (2 j_cap + 1)-float window per
    thread; past 32 lanes the wide route, one block of N padded to whole
    warps per scenario with whole (2 k_hi + 1)-row tables."""
    got = tdk.plan(n, 64, 48)
    assert got[:2] == (width, threads)
    rows = 2 * 48 + 1 if width else 2 * 64 + 1
    assert got[2] == rows * threads * 4
    if width:
        assert n <= width and 32 % width == 0 and (width == 8) == (n <= 8)


@pytest.mark.parametrize("k_hi,j_cap", [(48, 48), (512, 128), (512, 512), (2000, 900)])
def test_decide_plan_packed_window_follows_j_cap_alone(k_hi, j_cap):
    width, threads, smem = tdk.plan(7, k_hi, j_cap)
    assert (width, threads) == (8, 32)
    assert smem == (2 * j_cap + 1) * 32 * 4 <= tdk.SMEM_LIMIT


@pytest.mark.parametrize("shape,k_hi,j_cap,match", [
    ((4,), 8, None, r"lam must be \[B, N\]"),
    ((2, 7), 0, None, "k_hi must be >= 1"),
    ((2, 7), 2000, None, "shared memory"),  # one warp's window is past 227 KB
    ((2, 7), 2000, 48, None),  # ... but a j_cap window fits: on to the tensor checks
    ((2, 40), 600, None, "shared memory"),  # the wide route keeps whole tables
    ((2, 1025), 4, None, "exceed one block"),
])
def test_batch_decide_wrapper_checks_the_plan_first(shape, k_hi, j_cap, match):
    x = torch.ones(shape, dtype=torch.float32)
    flags = torch.ones(shape, dtype=torch.bool)
    with pytest.raises(ValueError, match=match or "CUDA"):
        tdk.batch_decide(x, x, group=flags, alpha=x, active=flags,
                         k_cur=torch.zeros(shape, dtype=torch.int32),
                         k_max=torch.ones(shape[:1], dtype=torch.int32), k_hi=k_hi,
                         j_cap=j_cap)


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def test_cuda_kernels_match_plain_versions(cuda_device):
    dev = cuda_device
    q = [_t(x.astype(np.float32)).to(dev) for x in _queue_case(4096)]
    for g, w in zip(tqk.queue_step(*q), tqr.queue_step(*q)):
        assert torch.equal(g, w)
    a = _t(np.abs(np.random.default_rng(0).normal(6, 5, 999)).astype(np.float32)).to(dev)
    assert torch.equal(tek.erlang_b_table(a, k_hi=512), ter.erlang_b_table(a, k_hi=512))
    cand, budget = (x.to(dev) for x in map(_t, _topr_case(b=64)))
    assert torch.equal(tgk.gain_topr(cand, budget), tgr.gain_topr(cand, budget))
    case = tuple(x.astype(np.float32) if x.dtype.kind == "f" else x for x in _decide_case())

    def wrap(x):
        return _t(x).to(dev)

    got = _run(tdk.batch_decide, case, 512, wrap, j_cap=48)
    want = _run(tdr.batch_decide, case, 512, wrap, j_cap=48)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _decide_inputs(b, n, k_hi, seed):
    """``chip_smoke.decide_inputs``'s patterns from numpy: an infeasible
    lane 0 in every ninth scenario, idle (zero-rate) and all-inactive
    scenarios, ~25 % gang lanes, a ragged last lane, budget 0 in every
    seventh scenario and budgets up to 29 past the floor elsewhere."""
    rng = np.random.default_rng(seed)
    mu = rng.uniform(1.0, 9.0, (b, n))
    lam = mu * rng.integers(1, 6, (b, n)) * rng.uniform(0.05, 0.95, (b, n))
    lam[::9, 0] = mu[::9, 0] * (k_hi + 5)
    lam[1::13] = 0.0
    group = rng.random((b, n)) < 0.25
    alpha = np.where(group, 0.02, 0.0)
    lam = np.where(group, np.minimum(lam, 0.2 * mu / 0.02), lam)
    active = np.ones((b, n), bool)
    active[:, n - 1] = rng.random(b) < 0.5
    active[2::11] = False
    lam = np.where(active, lam, 0.0)
    k_cur = rng.integers(0, 8, (b, n)).astype(np.int32)
    floor = np.where(active, np.floor(lam / mu) + 1, 0).sum(-1)
    k_max = (floor + rng.integers(0, 30, b)).astype(np.int32)
    k_max[3::7] = 0
    return (lam.astype(np.float32), mu.astype(np.float32), group, alpha.astype(np.float32),
            active, k_cur, k_max)


@pytest.mark.parametrize("b,n,k_hi,j_cap", [
    *[(67, n, 48, 48) for n in (1, 7, 8, 9, 16, 31, 32, 33, 64)],
    (1, 7, 48, 48), (3, 7, 48, 48), (4097, 7, 48, 48),
    (256, 7, 512, 128), (256, 32, 512, 128), (100, 7, 48, 16), (100, 40, 200, 24),
])
def test_cuda_batch_decide_matches_plain_bitwise(cuda_device, b, n, k_hi, j_cap):
    """Both routes (packed to N = 32, wide past it) at both segment widths,
    B off the scenarios-per-block grid, j_cap below k_hi, k_hi 48 and 512."""
    case = _decide_inputs(b, n, k_hi, seed=b + n + k_hi)

    def wrap(x):
        return _t(x).to(cuda_device)

    got = _run(tdk.batch_decide, case, k_hi, wrap, j_cap=j_cap)
    want = _run(tdr.batch_decide, case, k_hi, wrap, j_cap=j_cap)
    assert (want[1] == k_hi + 1).any() or n == 1 or b < 9  # an infeasible lane
    for name, g, w in zip(("k4", "k_start", "t_cur", "t4"), got, want):
        assert torch.equal(g, w), name


def _window_inputs(b, n, steps, seed):
    """``test_torch_window.window_case``'s patterns: padded lanes, ``+inf``
    and bounded queues, sparse routing, a mid-window ``warm`` switch."""
    rng = np.random.default_rng(seed)
    width = rng.integers(max(1, n - 3), n + 1, b)
    width[::5] = n
    lane = np.arange(n)[None, :] < width[:, None]
    pair = lane[:, :, None] & lane[:, None, :]
    routing = np.where(pair & (rng.random((b, n, n)) < 0.3),
                       rng.uniform(0.1, 1.1, (b, n, n)), 0.0)
    ext = np.where(lane, rng.poisson(rng.uniform(0.5, 8.0, (b, n)), (steps, b, n)), 0)
    caps = np.where(lane, rng.uniform(0.5, 6.0, (b, n)) * rng.integers(1, 4, (b, n)), 0.0)
    capq = np.where(lane & (rng.random((b, n)) < 0.5),
                    rng.integers(2, 30, (b, n)).astype(float), np.inf)
    q0 = np.where(lane, rng.uniform(0.0, 20.0, (b, n)), 0.0)
    sp0 = np.where(lane, rng.uniform(0.0, 3.0, (b, n)), 0.0)
    warm = (np.arange(steps) >= steps // 3)
    return [x.astype(np.float32) for x in (q0, sp0, ext, warm, caps, capq, routing)]


@pytest.mark.parametrize("b,n,steps,route", [
    (4096, 7, 100, None), (4096, 7, 100, ("segment", 32)), (4096, 7, 100, ("wide", 32)),
    (67, 1, 37, None), (67, 3, 9, None), (67, 9, 100, None), (67, 32, 20, None),
    (67, 8, 3, None), (50, 40, 100, None), (5, 100, 17, None), (3, 7, 0, None),
])
def test_cuda_queue_window_matches_plain_bitwise(cuda_device, b, n, steps, route,
                                                 monkeypatch):
    """Every route (segments of 8 and of 32 lanes, wide past 32 lanes or
    forced at the fleet shape), step counts off the prefetch ring, and the
    empty window; all 15 outputs bitwise."""
    args = [_t(x).to(cuda_device) for x in _window_inputs(b, n, steps, seed=b + n + steps)]
    if route is not None:
        monkeypatch.setattr(tqk, "plan", lambda _n, _r=route: _r)
    got = tqk.queue_window(*args)
    want = tqr.queue_window(*args)
    assert len(got) == len(want) == 15
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"output {i}"


@pytest.mark.parametrize("b,n,j,misaligned", [
    (4096, 7, 48, False), (4096, 7, 48, True), (67, 7, 47, False), (67, 32, 16, False),
    (67, 1, 1, False), (67, 5, 13, True), (67, 33, 4, False), (67, 8, 100, False),
])
def test_cuda_gain_topr_matches_plain_on_both_routes(cuda_device, b, n, j, misaligned):
    """The warp route (also on a view that is not 16-byte aligned) and the
    block route past N = 32 or 512 gains; ties, +inf, NaN and negative
    gains, budgets of 0, below 0, at and past the positives."""
    rng = np.random.default_rng(b + n + j)
    raw = rng.integers(0, 9, (b, n, j)).astype(np.float32) * 0.5
    cand = -np.sort(-raw, axis=-1)
    cand[1::3, 0, 0] = np.inf
    cand[2::5, n // 2, -1] = -1.5
    cand[4::7, 0, -1] = np.nan
    pos = (cand > 0).sum(axis=(1, 2))
    budget = rng.integers(1, int(pos.max()) + 2, b).astype(np.int32)
    budget[0::6], budget[1::6], budget[2::6] = 0, pos[1::6], pos[2::6] + 4
    budget[3::6] = -2
    c = _t(cand).to(cuda_device)
    if misaligned:
        c = torch.empty(c.numel() + 1, device=cuda_device)[1:].view_as(c).copy_(c)
    bud = _t(budget).to(cuda_device)
    assert torch.equal(tgk.gain_topr(c, bud), tgr.gain_topr(c, bud))


def _fleet_loads(dev, monkeypatch):
    """The offered loads the fleet-4096 loop (``chip_smoke.py``'s fleet,
    cut to two ticks) hands ``stationary_wait``'s Erlang-B table on its
    last tick: [4096 * 7] float32 on the card."""
    from repro_torch.api.session import ScenarioRunner
    from repro_torch.streaming.scenarios import scenario_matrix

    seen = []
    table = teo.erlang_b_table

    def record(a, *, k_hi):
        seen.append(a.clone())
        return table(a, k_hi=k_hi)

    monkeypatch.setattr(teo, "erlang_b_table", record)
    distinct = [s.with_(negotiated=False) for s in
                scenario_matrix(256, seed=5, horizon=10.0, warmup=5.0, dt=0.05, k_max=48)]
    ScenarioRunner(distinct * 16, tick_interval=5.0, fused_decide=True, device=dev).run()
    monkeypatch.setattr(teo, "erlang_b_table", table)
    return seen[-1]


@pytest.mark.parametrize("mix,s,k_hi", [
    ("fleet", 4096 * 7, 48), ("zero", 4096 * 7, 48), ("normal", 4096 * 7, 48),
    ("wide", 8192, 512),
])
def test_cuda_erlang_b_matches_plain_under_the_load_mixes(cuda_device, monkeypatch, mix, s,
                                                          k_hi):
    """The fleet's own loads, all-idle lanes (a = 0), loads in [10, 40]
    (B stays normal to row 48), and loads in [0, 300] to row 512."""
    rng = np.random.default_rng(s + k_hi)
    if mix == "fleet":
        a = _fleet_loads(cuda_device, monkeypatch)
    elif mix == "zero":
        a = torch.zeros(s, device=cuda_device)
    else:
        lo, hi = (10.0, 40.0) if mix == "normal" else (0.0, 300.0)
        a = _t(rng.uniform(lo, hi, s).astype(np.float32)).to(cuda_device)
    assert a.shape == (s,) and a.dtype == torch.float32
    got = tek.erlang_b_table(a, k_hi=k_hi)
    want = ter.erlang_b_table(a, k_hi=k_hi)
    assert torch.equal(got, want)
    tiny = torch.finfo(torch.float32).tiny
    if mix == "normal":
        assert bool((got >= tiny).all())
    if mix == "fleet":
        assert bool((a == 0).any()) and bool(((got > 0) & (got < tiny)).any())
