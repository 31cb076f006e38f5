"""The port's SSM scans against the JAX package.

The plain PyTorch scans (``repro_torch/kernels/{rwkv6,ssd}_scan/ref.py``,
what the dispatch runs for CPU tensors, and ``repro_torch/models/ssm.py``
in the model's layout) are held against the JAX package's Pallas kernels
in interpret mode, its per-chunk jnp oracles (``ref.py``) and its
``models/ssm.py`` chunked scans, on the same seeded numpy inputs, where
those are finite; the ``*_step`` recurrences against JAX's.  Float32 is
held to 1e-5 * (1 + the largest |want| in the row) (the same function,
with the intra-chunk weight formed as one ``exp`` of a difference instead
of a product of two ``exp``s, and sums in another order: an output that a
sum cancels to near 0 carries the rounding of its row's larger terms);
bf16 inputs are the same values in
both packages, computed in float32, so bf16 outputs differ by at most one
rounding: 2^-7 relative, held to 2^-6 of the output row's largest value.

Two faults of the JAX reference are pinned here, neither copied by the
port:

* the chunked scans form ``e^{-pc}`` and overflow float32 once a chunk's
  cumulative log-decay passes -88 (RWKV6 at its decay floor w = 0.05 over
  32 tokens, SSD at its clamp log a = -6 over 16 steps); the port is
  finite there and equals a float64 step recurrence;
* the RWKV6 CPU dispatch (``repro/kernels/rwkv6_scan/ops.py:17``) passes
  ``u[:1]``, so every stream gets stream 0's bonus.

The CUDA kernels run only on a card: ``tests/test_torch_ssm_kernels_cuda.py``
holds them against these plain versions, and ``chip_smoke.py`` at the
models' shapes.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_scan import kernel as jrk, ops as jro, ref as jrr
from repro.kernels.ssd_scan import kernel as jsk, ops as jso, ref as jsr
from repro.models import ssm as jssm
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.rwkv6_scan import kernel as trk, ops as tro, ref as trr
from repro_torch.kernels.ssd_scan import kernel as tsk, ops as tso, ref as tsr
from repro_torch.models import ssm as tssm

F32_TOL = 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol=F32_TOL):
    """|got - want| <= tol * (1 + max |want| over the last axis)."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert np.isfinite(got).all()
    limit = tol * (1 + np.abs(want).max(-1, keepdims=True))
    np.testing.assert_array_less(np.abs(got - want), np.broadcast_to(limit, want.shape))


def _close_row(got, want, tol=2 ** -6):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert np.isfinite(got).all()
    limit = tol * np.abs(want).max(-1, keepdims=True) + 1e-30
    np.testing.assert_array_less(np.abs(got - want), np.broadcast_to(limit, want.shape))


def _pair(x, dtype="float32"):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(np.ascontiguousarray(x)).to(td)


def _rwkv_inputs(seed, bh=6, s=64, dk=16, dv=16, w_lo=0.3):
    """Seeded r / k / v, decays spread over [w_lo, 0.9995), a bonus per
    stream and a non-zero initial state."""
    rng = np.random.default_rng(seed)
    r, k = (rng.standard_normal((bh, s, dk)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((bh, s, dv)).astype(np.float32)
    lw = np.log(rng.uniform(w_lo, 0.9995, (bh, s, dk))).astype(np.float32)
    u = rng.uniform(-0.3, 0.3, (bh, dk)).astype(np.float32)
    s0 = rng.standard_normal((bh, dk, dv)).astype(np.float32)
    return r, k, v, lw, u, s0


def _ssd_inputs(seed, bh=6, s=128, dh=16, dst=8, a_lo=-1.0):
    """Seeded x / B / C, log-decays spread over [a_lo, 0] and a non-zero
    initial state."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bh, s, dh)).astype(np.float32)
    a = rng.uniform(a_lo, 0.0, (bh, s)).astype(np.float32)
    b, c = (rng.standard_normal((bh, s, dst)).astype(np.float32) for _ in range(2))
    s0 = rng.standard_normal((bh, dst, dh)).astype(np.float32)
    return x, a, b, c, s0


def _rwkv_recurrence_f64(r, k, v, lw, u, s0):
    """The token-by-token WKV6 recurrence in float64 ([BH, S, D] numpy)."""
    r, k, v, w, u, st = (np.asarray(t, np.float64) for t in (r, k, v, np.exp(lw), u, s0))
    out = np.zeros(v.shape)
    for t in range(r.shape[1]):
        kv = k[:, t, :, None] * v[:, t, None, :]
        out[:, t] = np.einsum("bk,bkv->bv", r[:, t], st + u[:, :, None] * kv)
        st = w[:, t, :, None] * st + kv
    return out, st


def _ssd_recurrence_f64(x, a, b, c, s0):
    x, a, b, c, st = (np.asarray(t, np.float64) for t in (x, a, b, c, s0))
    y = np.zeros(x.shape)
    for t in range(x.shape[1]):
        st = np.exp(a[:, t])[:, None, None] * st + b[:, t, :, None] * x[:, t, None, :]
        y[:, t] = np.einsum("bs,bsd->bd", c[:, t], st)
    return y, st


# --------------------------------------------------------------------------- #
# RWKV6
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [32, 16])
def test_rwkv6_plain_scan_matches_pallas_interpret(dtype, chunk):
    r, k, v, lw, u, s0 = _rwkv_inputs(seed=1)
    (jr, tr), (jk, tk), (jv, tv) = (_pair(t, dtype) for t in (r, k, v))
    want, want_s = jrk.rwkv6_scan_pallas(jr, jk, jv, jnp.asarray(lw), jnp.asarray(u),
                                         jnp.asarray(s0), chunk=chunk, interpret=True)
    got, got_s = tro.rwkv6_scan(tr, tk, tv, torch.from_numpy(lw), torch.from_numpy(u),
                                torch.from_numpy(s0), chunk=chunk)
    assert got.dtype == DTYPES[dtype][1] and got_s.dtype == torch.float32
    (_close if dtype == "float32" else _close_row)(got, want)
    _close(got_s, want_s)


@pytest.mark.parametrize("c", [32, 7])
def test_rwkv6_plain_chunk_matches_jax_ref(c):
    r, k, v, lw, u, s0 = (t[0] for t in _rwkv_inputs(seed=2, s=c))
    want, want_s = jrr.rwkv6_chunk(*(jnp.asarray(t) for t in (r, k, v, lw, u, s0)))
    got, got_s = trr.rwkv6_chunk(*(torch.from_numpy(t) for t in (r, k, v, lw, u, s0)))
    _close(got, want)
    _close(got_s, want_s)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_chunked_matches_jax_model_layout(dtype):
    rng = np.random.default_rng(3)
    b, s, h, d = 2, 64, 3, 16
    r, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.3, 0.9995, (b, s, h, d)).astype(np.float32)
    u = rng.uniform(-0.3, 0.3, (h, d)).astype(np.float32)
    s0 = rng.standard_normal((b, h, d, d)).astype(np.float32)
    (jr, tr), (jk, tk), (jv, tv) = (_pair(t, dtype) for t in (r, k, v))
    want, want_s = jssm.rwkv6_chunked(jr, jk, jv, jnp.asarray(w), jnp.asarray(u), chunk=32,
                                      initial_state=jnp.asarray(s0))
    got, got_s = tssm.rwkv6_chunked(tr, tk, tv, torch.from_numpy(w), torch.from_numpy(u),
                                    chunk=32, initial_state=torch.from_numpy(s0))
    assert got.shape == (b, s, h, d)
    (_close if dtype == "float32" else _close_row)(got, want)
    _close(got_s, want_s)


def test_rwkv6_step_matches_jax_step():
    rng = np.random.default_rng(4)
    b, h, d = 3, 4, 16
    r, k, v = (rng.standard_normal((b, h, d)).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.05, 0.9995, (b, h, d)).astype(np.float32)
    u = rng.uniform(-0.3, 0.3, (h, d)).astype(np.float32)
    st = rng.standard_normal((b, h, d, d)).astype(np.float32)
    want, want_s = jssm.rwkv6_step(*(jnp.asarray(t) for t in (r, k, v, w, u, st)))
    got, got_s = tssm.rwkv6_step(*(torch.from_numpy(t) for t in (r, k, v, w, u, st)))
    _close(got, want)
    _close(got_s, want_s)


@pytest.mark.parametrize("w_lo,s", [(0.05, 64), (0.3, 50)])
def test_rwkv6_plain_scan_equals_float64_recurrence(w_lo, s):
    """Spread decays, and every decay at the model's floor w = 0.05; S = 50
    leaves a short last chunk."""
    r, k, v, lw, u, s0 = _rwkv_inputs(seed=5, s=s, w_lo=w_lo)
    if w_lo == 0.05:
        lw = np.full_like(lw, np.log(np.float32(0.05)))
    got, got_s = trr.rwkv6_scan(*(torch.from_numpy(t) for t in (r, k, v, lw, u, s0)), chunk=32)
    want, want_s = _rwkv_recurrence_f64(r, k, v, lw, u, s0)
    _close(got, want, 1e-4)
    _close(got_s, want_s, 1e-4)


def test_jax_rwkv6_chunked_overflows_at_the_decay_floor_and_the_port_does_not():
    r, k, v, lw, u, s0 = _rwkv_inputs(seed=6, bh=4, s=32)
    lw = np.full_like(lw, np.log(np.float32(0.05)))  # 32 x log(0.05) = -95.9
    jout, _ = jssm.rwkv6_chunked(*(jnp.asarray(t[:, :, None]) for t in (r, k, v, np.exp(lw))),
                                 jnp.asarray(u[:1]), chunk=32)
    assert not bool(jnp.isfinite(jout).all())
    jout, _ = jrk.rwkv6_scan_pallas(*(jnp.asarray(t) for t in (r, k, v, lw, u, s0)),
                                    chunk=32, interpret=True)
    assert not bool(jnp.isfinite(jout).all())
    got, got_s = tro.rwkv6_scan(*(torch.from_numpy(t) for t in (r, k, v, lw, u, s0)), chunk=32)
    want, want_s = _rwkv_recurrence_f64(r, k, v, lw, u, s0)
    _close(got, want, 1e-4)
    _close(got_s, want_s, 1e-4)


def test_jax_rwkv6_cpu_dispatch_gives_every_stream_stream_0s_bonus():
    r, k, v, lw, u, s0 = _rwkv_inputs(seed=7)
    args = [jnp.asarray(t) for t in (r, k, v, lw, u, s0)]
    interp, _ = jrk.rwkv6_scan_pallas(*args, interpret=True)
    dispatched, _ = jro.rwkv6_scan(*args)
    assert float(jnp.abs(dispatched - interp).max()) > 1.0  # the u[:1] gap
    same_u, _ = jrk.rwkv6_scan_pallas(*args[:4], jnp.broadcast_to(args[4][:1], u.shape),
                                      args[5], interpret=True)
    _close(dispatched, same_u)  # it is exactly stream 0's bonus everywhere
    got, _ = tro.rwkv6_scan(*(torch.from_numpy(t) for t in (r, k, v, lw, u, s0)))
    _close(got, interp)


def test_rwkv6_streams_layouts_agree():
    """[BH] streams, [B, H] streams as strided views of [B, S, H, D], and a
    bonus broadcast over the batch give the same result."""
    r, k, v, lw, u, s0 = _rwkv_inputs(seed=8, bh=6)
    t = {n: torch.from_numpy(a) for n, a in zip("r k v lw u s0".split(), (r, k, v, lw, u, s0))}
    u_heads = t["u"][:3]
    flat, flat_s = tro.rwkv6_scan(t["r"], t["k"], t["v"], t["lw"], u_heads.repeat(2, 1),
                                  t["s0"])

    def bshd(x):  # [BH, S, D] -> a [B, H, S, D] view of a [B, S, H, D] tensor
        return x.reshape(2, 3, *x.shape[1:]).transpose(1, 2).contiguous().transpose(1, 2)

    four, four_s = tro.rwkv6_scan(bshd(t["r"]), bshd(t["k"]), bshd(t["v"]), bshd(t["lw"]),
                                  u_heads, t["s0"].reshape(2, 3, 16, 16))
    np.testing.assert_array_equal(_np(four).reshape(6, 64, 16), _np(flat))
    np.testing.assert_array_equal(_np(four_s).reshape(6, 16, 16), _np(flat_s))


# --------------------------------------------------------------------------- #
# SSD
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [64, 32])
def test_ssd_plain_scan_matches_pallas_interpret(dtype, chunk):
    x, a, b, c, s0 = _ssd_inputs(seed=11)
    (jx, tx), (jb, tb), (jc, tc) = (_pair(t, dtype) for t in (x, b, c))
    want, want_s = jsk.ssd_scan_pallas(jx, jnp.asarray(a), jb, jc, jnp.asarray(s0), chunk=chunk,
                                       interpret=True)
    got, got_s = tso.ssd_scan(tx, torch.from_numpy(a), tb, tc, torch.from_numpy(s0), chunk=chunk)
    assert got.dtype == DTYPES[dtype][1] and got_s.dtype == torch.float32
    (_close if dtype == "float32" else _close_row)(got, want)
    _close(got_s, want_s)


@pytest.mark.parametrize("n", [64, 9])
def test_ssd_plain_chunk_matches_jax_ref(n):
    x, a, b, c, s0 = (t[0] for t in _ssd_inputs(seed=12, s=n))
    want, want_s = jsr.ssd_chunk(*(jnp.asarray(t) for t in (x, a, b, c, s0)))
    got, got_s = tsr.ssd_chunk(*(torch.from_numpy(t) for t in (x, a, b, c, s0)))
    _close(got, want)
    _close(got_s, want_s)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_matches_jax_model_layout(dtype):
    """B and C shared by all heads, as zamba2 passes them (an expanded view
    in the port, a broadcast in JAX)."""
    rng = np.random.default_rng(13)
    bsz, s, h, dh, dst = 2, 128, 3, 16, 8
    x = rng.standard_normal((bsz, s, h, dh)).astype(np.float32)
    a = rng.uniform(-1.0, 0.0, (bsz, s, h)).astype(np.float32)
    bm, cm = (rng.standard_normal((bsz, s, dst)).astype(np.float32) for _ in range(2))
    s0 = rng.standard_normal((bsz, h, dst, dh)).astype(np.float32)
    (jx, tx), (jb, tb), (jc, tc) = (_pair(t, dtype) for t in (x, bm, cm))
    want, want_s = jssm.ssd_chunked(
        jx, jnp.asarray(a), jnp.broadcast_to(jb[:, :, None], (bsz, s, h, dst)),
        jnp.broadcast_to(jc[:, :, None], (bsz, s, h, dst)), chunk=64,
        initial_state=jnp.asarray(s0))
    got, got_s = tssm.ssd_chunked(tx, torch.from_numpy(a), tb[:, :, None].expand(bsz, s, h, dst),
                                  tc[:, :, None].expand(bsz, s, h, dst), chunk=64,
                                  initial_state=torch.from_numpy(s0))
    assert got.shape == (bsz, s, h, dh)
    (_close if dtype == "float32" else _close_row)(got, want)
    _close(got_s, want_s)


def test_ssd_step_matches_jax_step():
    rng = np.random.default_rng(14)
    b, h, dh, dst = 3, 4, 16, 8
    x = rng.standard_normal((b, h, dh)).astype(np.float32)
    a = rng.uniform(-6.0, 0.0, (b, h)).astype(np.float32)
    bv, cv = (rng.standard_normal((b, h, dst)).astype(np.float32) for _ in range(2))
    st = rng.standard_normal((b, h, dst, dh)).astype(np.float32)
    want, want_s = jssm.ssd_step(*(jnp.asarray(t) for t in (x, a, bv, cv, st)))
    got, got_s = tssm.ssd_step(*(torch.from_numpy(t) for t in (x, a, bv, cv, st)))
    _close(got, want)
    _close(got_s, want_s)


@pytest.mark.parametrize("a_lo,s", [(-6.0, 128), (-1.0, 100)])
def test_ssd_plain_scan_equals_float64_recurrence(a_lo, s):
    """Every log-decay at the model's clamp -6, and spread decays with a
    short last chunk (S = 100)."""
    x, a, b, c, s0 = _ssd_inputs(seed=15, s=s, a_lo=a_lo)
    if a_lo == -6.0:
        a = np.full_like(a, -6.0)
    got, got_s = tsr.ssd_scan(*(torch.from_numpy(t) for t in (x, a, b, c, s0)), chunk=64)
    want, want_s = _ssd_recurrence_f64(x, a, b, c, s0)
    _close(got, want, 1e-4)
    _close(got_s, want_s, 1e-4)


def test_jax_ssd_chunked_overflows_at_the_clamp_and_the_port_does_not():
    x, a, b, c, s0 = _ssd_inputs(seed=16, bh=4, s=64)
    a = np.full_like(a, -6.0)  # 16 steps pass -88
    jy, _ = jso.ssd_scan(*(jnp.asarray(t) for t in (x, a, b, c, s0)))
    assert not bool(jnp.isfinite(jy).all())
    jy, _ = jsk.ssd_scan_pallas(*(jnp.asarray(t) for t in (x, a, b, c, s0)), interpret=True)
    assert not bool(jnp.isfinite(jy).all())
    got, got_s = tso.ssd_scan(*(torch.from_numpy(t) for t in (x, a, b, c, s0)))
    want, want_s = _ssd_recurrence_f64(x, a, b, c, s0)
    _close(got, want, 1e-4)
    _close(got_s, want_s, 1e-4)


def test_ssd_dispatch_matches_jax_dispatch_where_finite():
    x, a, b, c, s0 = _ssd_inputs(seed=17)
    want, want_s = jso.ssd_scan(*(jnp.asarray(t) for t in (x, a, b, c, s0)))
    got, got_s = tso.ssd_scan(*(torch.from_numpy(t) for t in (x, a, b, c, s0)))
    _close(got, want)
    _close(got_s, want_s)


# --------------------------------------------------------------------------- #
# The wrappers on the CPU
# --------------------------------------------------------------------------- #
def test_cpu_dispatch_never_launches_and_kernels_refuse_cpu_tensors():
    before = dict(LAUNCHES)
    r, k, v, lw, u, s0 = (torch.from_numpy(t) for t in _rwkv_inputs(seed=20, s=8))
    tro.rwkv6_scan(r, k, v, lw, u, s0)
    x, a, b, c, st = (torch.from_numpy(t) for t in _ssd_inputs(seed=21, s=8))
    tso.ssd_scan(x, a, b, c, st)
    assert dict(LAUNCHES) == before
    with pytest.raises(ValueError, match="CUDA"):
        trk.rwkv6_scan(r, k, v, lw, u, s0)
    with pytest.raises(ValueError, match="CUDA"):
        tsk.ssd_scan(x, a, b, c, st)


def test_kernel_wrappers_check_shapes_before_the_device():
    r, k, v, lw, u, s0 = (torch.from_numpy(t) for t in _rwkv_inputs(seed=22, s=8))
    with pytest.raises(ValueError, match="chunk"):
        trk.rwkv6_scan(r, k, v, lw, u, s0, chunk=65)
    with pytest.raises(ValueError, match="do not fit|shape"):
        trk.rwkv6_scan(r, k[:, :4], v, lw, u, s0)
    x, a, b, c, st = (torch.from_numpy(t) for t in _ssd_inputs(seed=23, s=8))
    with pytest.raises(ValueError, match="Dst"):
        tsk.ssd_scan(x, a, b.repeat(1, 1, 9), c.repeat(1, 1, 9), None)
    with pytest.raises(ValueError, match="x .*a"):
        tsk.ssd_scan(x, a[:, :4], b, c, st)


# (B, H, Dh, Dst, bf16 aligned, B / C shared) -> (heads per block, columns).
@pytest.mark.parametrize("nb,nh,dh,dst,tc,shared,want", [
    (4, 112, 64, 64, True, True, (2, 64)),    # zamba2's prefill: C B^T once per head pair
    (1, 112, 64, 64, True, True, (1, 32)),    # B = 1: narrower columns fill the card
    (4, 112, 64, 64, True, False, (1, 64)),   # per-head B / C: one head per block
    (2, 6, 64, 16, True, False, (1, 16)),
    (4, 112, 64, 64, False, True, (0, None)),  # float32 / unaligned: the CUDA-core kernel
    (4, 112, 40, 64, True, True, (0, None)),   # Dh off the 16-column tiles
    (4, 112, 64, 60, True, True, (0, None)),   # Dst off the 8-wide rows
])
def test_ssd_launch_plan(nb, nh, dh, dst, tc, shared, want):
    heads, vb = tsk.plan(nb, nh, dh, dst, 132, tensor_cores=tc, shared_bc=shared)
    assert (heads, vb) == want
    if heads:
        assert nh % heads == 0 and dh % vb == 0 and vb in (16, 32, 64)
        assert nb * nh // heads * (dh // vb) >= 132 or vb == 16
