"""The port's scan kernels, and the attention kernels at zamba2's head dim,
against their plain PyTorch versions on the card.

These tests need a CUDA device and skip without one (the kernels have no
CPU mode).  They import no JAX, so they also run where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_ssm_kernels_cuda.py

Scans: kernel and plain version compute in float32 (the kernel with fmaf
and its own summation order), so float32 is held to 1e-4 of (1 + the
output row's largest |value|) -- a state carried over many chunks and an
output that cancels to near 0 carry their row's rounding -- and bf16,
rounded once from those values, to two bf16 ulps (2^-6) of the row's
largest value.  At the models' clamp floors (w = 0.05, log a = -6) the
kernels are held to a float64 step recurrence at the float32 rule (bf16:
the recurrence over the same bf16 inputs, rounded to bf16, at the bf16
rule).  bf16 ``rwkv6_scan`` runs on the tensor cores where its rows are
16-byte aligned; its cases cover both of that kernel's branches (anchored
factors; the exact per-pair loop for chunks whose decay is steeper than
the anchor allows, w = 1e-8) and the CUDA-core kernel for a view off the
grid.
Attention at head dim 112 keeps the LLM kernels' rules: two bf16 ulps of
the row's largest value, 2e-5 * (1 + |plain|) in float32.  SwiGLU at
zamba2's shared FFN width (D 3584, F 14336) keeps its rule: 5e-2 (bf16) or
2e-3 (float32) of the output's largest value -- in bf16 the plain
version rounds the gate and up products before the silu, the kernel keeps
them in float32 as the TPU kernel does.
"""

from __future__ import annotations

import math

import pytest
import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.decode_attention import kernel as tdk, ref as tdr
from repro_torch.kernels.flash_attention import kernel as tfk, ref as tfr
from repro_torch.kernels.rwkv6_scan import kernel as trk, ops as tro, ref as trr
from repro_torch.kernels.ssd_scan import kernel as tsk, ops as tso, ref as tsr
from repro_torch.kernels.swiglu import kernel as tgk, ref as tgr

SCAN_TOL = {torch.bfloat16: 2 ** -6, torch.float32: 1e-4}
ATTN_TOL = {torch.bfloat16: 2 ** -6, torch.float32: 2e-5}
SWIGLU_TOL = {torch.bfloat16: 5e-2, torch.float32: 2e-3}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _assert_scan_close(got, want, tol=None):
    """bf16: |d| <= tol * max |want| over the row; float32: tol * (1 + that max)."""
    bf16 = want.dtype == torch.bfloat16
    tol = tol or SCAN_TOL[want.dtype]
    got, want = got.double(), want.double()
    row = want.abs().amax(-1, keepdim=True)
    limit = tol * row if bf16 else tol * (1 + row)
    diff = (got - want).abs()
    assert torch.isfinite(got).all()
    assert bool((diff <= limit).all()), f"max abs err {float(diff.max())}"


def _assert_attention_close(got, want):
    bf16, tol = want.dtype == torch.bfloat16, ATTN_TOL[want.dtype]
    got, want = got.double(), want.double()
    limit = tol * want.abs().amax(-1, keepdim=True) if bf16 else tol * (1 + want.abs())
    diff = (got - want).abs()
    assert torch.isfinite(got).all()
    assert bool((diff <= limit).all()), f"max abs err {float(diff.max())}"


def _log_decay(shape, lo, hi, gen):
    """-exp(U(log lo, log hi)): log-decays spread over [-hi, -lo]."""
    x = torch.rand(shape, generator=gen) * (math.log(hi) - math.log(lo)) + math.log(lo)
    return -torch.exp(x)


def _rwkv(b, s, h, d, gen, floor=False):
    """[B, H, S, D] views of [B, S, H, D] tensors, decays over the model's
    clamp [0.05, 0.9995] (or all at the floor), a bonus per head, a state."""
    r, k, v = (torch.randn(b, s, h, d, generator=gen).transpose(1, 2) for _ in range(3))
    lw = _log_decay((b, s, h, d), 5e-4, -math.log(0.05), gen).transpose(1, 2)
    if floor:
        lw = torch.full_like(lw, math.log(0.05))
    u = torch.rand(h, d, generator=gen) * 0.6 - 0.3
    return r, k, v, lw, u, torch.randn(b, h, d, d, generator=gen)


def _ssd(b, s, h, dh, dst, gen, floor=False, shared=True):
    """x as a [B, H, S, Dh] view, B / C [B, S, Dst] expanded over the heads
    (head stride 0) or, unshared, [B, H, S, Dst] views of [B, S, H, Dst],
    log-decays over [-6, -1e-3] (or all at -6), a state."""
    x = torch.randn(b, s, h, dh, generator=gen).transpose(1, 2)
    a = _log_decay((b, s, h), 1e-3, 6.0, gen).transpose(1, 2)
    if floor:
        a = torch.full_like(a, -6.0)
    if shared:
        bm, cm = (torch.randn(b, s, dst, generator=gen)[:, None].expand(b, h, s, dst)
                  for _ in range(2))
    else:
        bm, cm = (torch.randn(b, s, h, dst, generator=gen).transpose(1, 2) for _ in range(2))
    return x, a, bm, cm, torch.randn(b, h, dst, dh, generator=gen)


def _to(dev, dtype, tensors, f32=(3, 4, 5)):
    """Move to the card; operands in ``dtype``, the positions in ``f32`` in
    float32 (decays, bonus, state)."""
    return [t.to(dev, torch.float32 if i in f32 else dtype) if t is not None else None
            for i, t in enumerate(tensors)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,chunk", [(256, 32), (100, 32), (64, 16), (5, 32)])
def test_cuda_rwkv6_scan_matches_plain(cuda_device, dtype, s, chunk):
    gen = torch.Generator().manual_seed(0)
    args = _to(cuda_device, dtype, _rwkv(2, s, 4, 64, gen))
    before = LAUNCHES["rwkv6_scan"]
    o, st = trk.rwkv6_scan(*args, chunk=chunk)
    assert LAUNCHES["rwkv6_scan"] == before + 1
    po, pst = trr.rwkv6_scan(*args, chunk=chunk)
    assert o.dtype == po.dtype and o.shape == po.shape and st.dtype == torch.float32
    _assert_scan_close(o, po)
    _assert_scan_close(st, pst, SCAN_TOL[torch.float32])


# (B, S, chunk) of the tensor-core route: chunk 32 (the model's) and 64, S
# under one chunk, a short last chunk, whole chunks; B = 1 narrows the
# column slices to 16.
RWKV_MMA_CASES = [(1, 5, 32), (1, 100, 32), (1, 256, 32), (1, 5, 64), (1, 100, 64),
                  (1, 256, 64), (2, 256, 32), (2, 100, 64)]


@pytest.mark.parametrize("b,s,chunk", RWKV_MMA_CASES)
def test_cuda_rwkv6_tensor_core_route_matches_plain(cuda_device, b, s, chunk):
    gen = torch.Generator().manual_seed(7)
    args = _to(cuda_device, torch.bfloat16, _rwkv(b, s, 4, 64, gen))
    assert trk.tensor_cores(*args[:4])
    before = LAUNCHES["rwkv6_scan"]
    o, st = trk.rwkv6_scan(*args, chunk=chunk)
    assert LAUNCHES["rwkv6_scan"] == before + 1
    po, pst = trr.rwkv6_scan(*args, chunk=chunk)
    assert o.dtype == po.dtype == torch.bfloat16 and o.shape == po.shape
    _assert_scan_close(o, po)
    _assert_scan_close(st, pst, SCAN_TOL[torch.float32])


def _steep(lw, kind, chunk):
    """Log-decays: all at the model's floor w = 0.05 ("floor"), all at the
    ssm module's clamp w = 1e-8 ("1e-8"), or chunks alternating between
    1e-8 and ``lw``'s spread over the model's clamp ("mixed")."""
    if kind == "floor":
        return torch.full_like(lw, math.log(0.05))
    steep = torch.full_like(lw, math.log(1e-8))
    if kind == "1e-8":
        return steep
    odd = (torch.arange(lw.shape[2]) // chunk) % 2 == 1
    return torch.where(odd[:, None], lw, steep)


@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("kind", ["floor", "1e-8", "mixed"])
def test_cuda_rwkv6_tensor_core_route_at_steep_decays(cuda_device, kind, chunk):
    """At the floor with chunk 32 every chunk takes the anchored factors
    (halves span 48 < 60), with chunk 64 the exact loop (96); at 1e-8 every
    chunk takes the exact loop; "mixed" has both branches in one launch."""
    gen = torch.Generator().manual_seed(8)
    r, k, v, lw, u, s0 = _rwkv(1, 256, 2, 64, gen)
    args = _to(cuda_device, torch.bfloat16, (r, k, v, _steep(lw, kind, chunk), u, s0))
    assert trk.tensor_cores(*args[:4])
    o, st = trk.rwkv6_scan(*args, chunk=chunk)
    po, pst = trr.rwkv6_scan(*args, chunk=chunk)
    _assert_scan_close(o, po)
    _assert_scan_close(st, pst, SCAN_TOL[torch.float32])
    if kind == "floor":
        want, sd = _rwkv_f64_steps(*args)
        _assert_scan_close(o.cpu(), want.to(torch.bfloat16))
        _assert_scan_close(st.cpu(), sd.float())


def test_cuda_rwkv6_misaligned_bf16_view_takes_the_cuda_core_kernel(cuda_device):
    gen = torch.Generator().manual_seed(9)
    r, k, v, lw, u, s0 = _rwkv(2, 100, 4, 64, gen)
    wide = torch.randn(2, 100, 4, 65, generator=gen).to(cuda_device, torch.bfloat16)
    args = _to(cuda_device, torch.bfloat16, (r, k, v, lw, u, s0))
    args[0] = wide[..., 1:].transpose(1, 2)  # r one element off the 16-byte grid
    assert not trk.tensor_cores(*args[:4])
    o, st = trk.rwkv6_scan(*args)
    po, pst = trr.rwkv6_scan(*args)
    _assert_scan_close(o, po)
    _assert_scan_close(st, pst, SCAN_TOL[torch.float32])


def test_cuda_rwkv6_tensor_core_route_takes_the_bh_layout(cuda_device):
    gen = torch.Generator().manual_seed(10)
    r, k, v, lw, u, s0 = _rwkv(2, 70, 3, 64, gen)
    flat = [t.contiguous().reshape(6, 70, 64) for t in (r, k, v, lw)]
    args = _to(cuda_device, torch.bfloat16, (*flat, u.repeat(2, 1), s0.reshape(6, 64, 64)))
    assert trk.tensor_cores(*args[:4])
    o, st = tro.rwkv6_scan(*args)
    po, pst = trr.rwkv6_scan(*args)
    assert o.shape == (6, 70, 64) and o.is_contiguous()
    _assert_scan_close(o, po)
    _assert_scan_close(st, pst, SCAN_TOL[torch.float32])


# (B, H, S, chunk, Dh): whole chunks, a short last chunk (S = 100), S
# under one chunk, chunk 32 at Dh 32, B = 1 (the launch narrows the
# column slices to fill the card), Dh 128 (two column slices) and zamba2's
# 112 heads at B = 1.
SSD_CASES = [(2, 6, 256, 64, 64), (2, 6, 100, 64, 64), (2, 6, 300, 32, 32), (2, 6, 40, 64, 64),
             (1, 6, 100, 64, 64), (1, 4, 130, 64, 128), (1, 112, 200, 64, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("b,h,s,chunk,dh", SSD_CASES)
def test_cuda_ssd_scan_matches_plain(cuda_device, dtype, shared, b, h, s, chunk, dh):
    gen = torch.Generator().manual_seed(1)
    x, a, bm, cm, s0 = _ssd(b, s, h, dh, 64, gen, shared=shared)
    args = [x.to(cuda_device, dtype), a.to(cuda_device), bm.to(cuda_device, dtype),
            cm.to(cuda_device, dtype), s0.to(cuda_device)]
    before = LAUNCHES["ssd_scan"]
    y, st = tsk.ssd_scan(*args, chunk=chunk)
    assert LAUNCHES["ssd_scan"] == before + 1
    py, pst = tsr.ssd_scan(*args, chunk=chunk)
    assert y.dtype == py.dtype and y.shape == py.shape and st.dtype == torch.float32
    _assert_scan_close(y, py)
    _assert_scan_close(st, pst, SCAN_TOL[torch.float32])


def _rwkv_f64_steps(r, k, v, lw, u, s0):
    """The RWKV6 recurrence one token at a time in float64 (on the CPU)."""
    rd, kd, vd, w, ud, sd = (t.cpu().double() for t in (r, k, v, lw.exp(), u, s0))
    want = torch.empty_like(vd)
    for t in range(rd.shape[2]):
        kv = kd[:, :, t, :, None] * vd[:, :, t, None, :]
        want[:, :, t] = torch.einsum("bhk,bhkv->bhv", rd[:, :, t], sd + ud[..., None] * kv)
        sd = w[:, :, t, :, None] * sd + kv
    return want, sd


def test_cuda_scans_at_the_clamp_floors_match_float64_steps(cuda_device):
    gen = torch.Generator().manual_seed(2)
    r, k, v, lw, u, s0 = _rwkv(1, 128, 2, 64, gen, floor=True)
    o, st = trk.rwkv6_scan(*_to(cuda_device, torch.float32, (r, k, v, lw, u, s0)))
    want, sd = _rwkv_f64_steps(r, k, v, lw, u, s0)
    _assert_scan_close(o.cpu(), want.float())
    _assert_scan_close(st.cpu(), sd.float())
    x, a, bm, cm, s0 = _ssd(1, 128, 2, 64, 64, gen, floor=True)
    y, st = tsk.ssd_scan(x.to(cuda_device), a.to(cuda_device), bm.to(cuda_device),
                         cm.to(cuda_device), s0.to(cuda_device))
    xd, ad, bd, cd, sd = (t.double() for t in (x, a, bm, cm, s0))
    want = torch.empty_like(xd)
    for t in range(128):
        sd = ad[:, :, t, None, None].exp() * sd + bd[:, :, t, :, None] * xd[:, :, t, None, :]
        want[:, :, t] = torch.einsum("bhs,bhsd->bhd", cd[:, :, t], sd)
    _assert_scan_close(y.cpu(), want.float())
    _assert_scan_close(st.cpu(), sd.float())


def test_cuda_scans_take_the_bh_layout_and_no_initial_state(cuda_device):
    gen = torch.Generator().manual_seed(3)
    r, k, v, lw, u, _ = _rwkv(2, 70, 3, 64, gen)
    flat = [t.contiguous().reshape(6, 70, 64) for t in (r, k, v, lw)]
    args = _to(cuda_device, torch.float32, (*flat, u.repeat(2, 1), None))
    o, st = tro.rwkv6_scan(*args)
    po, pst = trr.rwkv6_scan(*args)
    assert o.shape == (6, 70, 64) and o.is_contiguous()
    _assert_scan_close(o, po)
    _assert_scan_close(st, pst)
    x = torch.randn(6, 70, 64, generator=gen)
    a = _log_decay((6, 70), 1e-3, 6.0, gen)
    bm, cm = (torch.randn(6, 70, 16, generator=gen) for _ in range(2))
    args = [t.to(cuda_device) for t in (x, a, bm, cm)]
    y, st = tso.ssd_scan(*args)
    py, pst = tsr.ssd_scan(*args)
    assert y.shape == (6, 70, 64) and y.is_contiguous()
    _assert_scan_close(y, py)
    _assert_scan_close(st, pst)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,window,causal", [
    (2, 200, 200, None, True), (2, 129, 300, None, True), (2, 1, 77, None, True),
    (2, 300, 300, 100, True), (2, 200, 330, 64, True), (2, 200, 300, None, False),
    (8, 700, 700, None, True)])
def test_cuda_flash_at_head_dim_112_matches_plain(cuda_device, dtype, b, sq, skv, window,
                                                  causal):
    """zamba2's shared block (MHA, Dh 112) in the model's [B, S, H, Dh]
    layout, off the 64-row tiles, windowed and bidirectional."""
    gen = torch.Generator().manual_seed(4)
    q = torch.randn(b, sq, 4, 112, generator=gen).to(cuda_device, dtype).transpose(1, 2)
    k, v = (torch.randn(b, skv, 4, 112, generator=gen).to(cuda_device, dtype).transpose(1, 2)
            for _ in range(2))
    kw = dict(causal=causal, window=window)
    _assert_attention_close(tfk.attention(q, k, v, **kw), tfr.attention(q, k, v, **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,length,window", [(3, 1, None), (3, 777, None), (3, 0, None),
                                             (3, 0, 50), (3, 800, None), (3, 800, 20),
                                             (1, 799, None), (16, 401, 100)])
def test_cuda_decode_at_head_dim_112_matches_plain(cuda_device, dtype, b, length, window):
    gen = torch.Generator().manual_seed(5)
    q = torch.randn(b, 4, 112, generator=gen).to(cuda_device, dtype)
    k, v = (torch.randn(b, 800, 4, 112, generator=gen).to(cuda_device, dtype) for _ in range(2))
    n = torch.tensor(length, dtype=torch.int32, device=cuda_device)
    _assert_attention_close(tdk.decode_attention(q, k, v, n, window=window),
                            tdr.decode_attention(q, k, v, n, window=window))


@pytest.mark.parametrize("t,dtype", [(4, torch.float32), (4, torch.bfloat16),
                                     (16384, torch.bfloat16)])
def test_cuda_swiglu_at_zamba2_width_matches_plain(cuda_device, t, dtype):
    """The shapes of zamba2's shared FFN: a decode step of 4 tokens and the
    4 x 4096 prefill."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    d, f = 3584, 14336

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=cuda_device) * scale).to(dtype)

    x, wg, wu, wo = randn(t, d), randn(d, f, scale=d ** -0.5), randn(d, f, scale=d ** -0.5), \
        randn(f, d, scale=f ** -0.5)
    before = LAUNCHES["swiglu"]
    got = tgk.swiglu(x, wg, wu, wo)
    assert LAUNCHES["swiglu"] == before + 2
    want = tgr.swiglu(x, wg, wu, wo)
    assert got.dtype == want.dtype and got.shape == want.shape == (t, d)
    tol = SWIGLU_TOL[dtype]
    got, want = got.double(), want.double()
    assert torch.isfinite(got).all()
    err = float((got - want).abs().max())
    assert err <= tol * float(want.abs().max()), f"max abs err {err}"
