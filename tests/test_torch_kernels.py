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
