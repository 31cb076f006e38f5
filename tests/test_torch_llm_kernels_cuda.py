"""The port's LLM CUDA kernels against their plain PyTorch versions, on the
card.

These tests need a CUDA device and skip without one (the kernels have no
CPU mode).  They import no JAX, so they also run where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_llm_kernels_cuda.py

Attention: kernel and plain version both compute the softmax and the sums
in float32 and round the output once, so in bf16 they may differ by one
ulp, 2^-7 of the largest value in the output row; the limit is two ulps.
The bf16 flash kernel also rounds each softmax weight to bf16 before the
P V product on the tensor cores (as FlashAttention-2 and SDPA do): <=
2^-9 relative per weight, random in sign, so its effect on an output is
far below one ulp of the row's largest value.  In float32 the limit,
2e-5 * (1 + |plain|), sits above summation-order noise (the decode
kernel's split-KV combine merges in another order) and below what one
key too many or too few moves an output.  SwiGLU: the plain version rounds
the gate and up products to bf16, the kernel rounds their silu product
once, so bf16 is held to 5e-2 of the output's magnitude.
"""

from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.decode_attention import kernel as tdk, ref as tdr
from repro_torch.kernels.flash_attention import kernel as tfk, ref as tfr
from repro_torch.kernels.swiglu import kernel as tgk, ref as tgr

ATTN_TOL = {torch.bfloat16: 2 ** -6, torch.float32: 2e-5}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _assert_attention_close(got, want):
    """bf16: |d| <= tol * max |want| over the row; float32: tol * (1 + |want|)."""
    bf16, tol = want.dtype == torch.bfloat16, ATTN_TOL[want.dtype]
    got, want = got.double(), want.double()
    limit = tol * want.abs().amax(-1, keepdim=True) if bf16 else tol * (1 + want.abs())
    diff = (got - want).abs()
    assert torch.isfinite(got).all()
    assert bool((diff <= limit).all()), f"max abs err {float(diff.max())}"


# (B, Sq, Skv, window, causal): Sq and Skv off the 64 / 128-row tiles, a
# single query, windows crossing key tiles, bidirectional with Sq < Skv and
# Sq > Skv, and enough (batch, head) blocks that the reversed (longest
# first) query-tile order runs over several waves.
FLASH_CASES = [(2, 200, 200, None, True), (2, 128, 300, None, True), (2, 256, 256, 64, True),
               (2, 129, 300, None, True), (2, 1, 77, None, True), (2, 300, 300, 100, True),
               (2, 200, 330, 64, True), (2, 200, 300, None, False), (2, 77, 1, None, False),
               (8, 1000, 1000, None, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,window,causal", FLASH_CASES)
def test_cuda_flash_matches_plain(cuda_device, dtype, b, sq, skv, window, causal):
    """llama3.2-1b's heads: Dh 64, four query heads per KV head."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(b, 8, sq, 64, generator=gen).to(cuda_device, dtype)
    k = torch.randn(b, 2, skv, 64, generator=gen).to(cuda_device, dtype)
    v = torch.randn(b, 2, skv, 64, generator=gen).to(cuda_device, dtype)
    got = tfk.attention(q, k, v, causal=causal, window=window)
    want = tfr.attention(q, k, v, causal=causal, window=window)
    assert got.dtype == want.dtype and got.shape == want.shape
    _assert_attention_close(got, want)


def test_cuda_flash_bf16_refuses_misaligned_rows(cuda_device):
    """The bf16 kernel copies whole 16-byte rows: a base pointer or a
    stride off the 16-byte grid raises (no route to another kernel)."""
    flat = torch.randn(2 * 8 * 64 * 64 + 1, device=cuda_device).to(torch.bfloat16)
    shifted = flat[1:].view(2, 64, 8, 64).transpose(1, 2)  # base 2 bytes off
    ok = torch.randn(2, 64, 2, 64, device=cuda_device).to(torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="16-byte"):
        tfk.attention(shifted, ok, ok)
    wide = torch.randn(2, 64, 2, 65, device=cuda_device).to(torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        tfk.attention(flat[:-1].view(2, 64, 8, 64).transpose(1, 2), ok,
                      wide[..., :64].transpose(1, 2))  # head stride 65
    tfk.attention(flat[:-1].view(2, 64, 8, 64).transpose(1, 2), ok, ok)  # aligned: runs


# (B, S_max, length, window): lengths 0 (the mean of V, as ref.py), 1, one
# split, around a split boundary, S_max; a window shorter than a split;
# B = 1 (many splits) and B = 16 (few).
DECODE_CASES = [(3, 1024, 1, None), (3, 1024, 1000, None), (3, 1024, 1000, 100),
                (3, 1024, 0, None), (3, 1024, 0, 100), (3, 1024, 64, None),
                (3, 1024, 255, None), (3, 1024, 256, None), (3, 1024, 257, None),
                (3, 1024, 1024, None), (3, 1024, 1024, 30), (1, 8192, 5000, None),
                (1, 8192, 8192, 700), (1, 8192, 0, None), (16, 1024, 777, None),
                (16, 1024, 1024, 50)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s_max,length,window", DECODE_CASES)
def test_cuda_decode_matches_plain(cuda_device, dtype, b, s_max, length, window):
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(b, 8, 64, generator=gen).to(cuda_device, dtype)
    k = torch.randn(b, s_max, 2, 64, generator=gen).to(cuda_device, dtype)
    v = torch.randn(b, s_max, 2, 64, generator=gen).to(cuda_device, dtype)
    n = torch.tensor(length, dtype=torch.int32, device=cuda_device)
    got = tdk.decode_attention(q, k, v, n, window=window)
    want = tdr.decode_attention(q, k, v, n, window=window)
    assert got.dtype == want.dtype and got.shape == want.shape
    _assert_attention_close(got, want)


# (D, F): a small ragged width, llama3.2-1b's FFN and zamba2-7b's.  T: the
# weight-streaming path (1, 4, 15, 16 rows), the tiled path just past it
# (17), off the 128-row tiles (129, 200) and several row tiles (4,100).
SWIGLU_WIDTHS = [(256, 520), (2048, 8192), (3584, 14336)]


def _swiglu_inputs(dev, dtype, t, d, f, seed=2):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    return (randn(t, d), randn(d, f, scale=d ** -0.5), randn(d, f, scale=d ** -0.5),
            randn(f, d, scale=f ** -0.5))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-3), (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("t", [1, 4, 15, 16, 17, 129, 200, 4100])
@pytest.mark.parametrize("d,f", SWIGLU_WIDTHS)
def test_cuda_swiglu_matches_plain(cuda_device, dtype, tol, t, d, f):
    x, wg, wu, wo = _swiglu_inputs(cuda_device, dtype, t, d, f)
    before = LAUNCHES["swiglu"]
    got = tgk.swiglu(x, wg, wu, wo)
    assert LAUNCHES["swiglu"] == before + 2
    want = tgr.swiglu(x, wg, wu, wo)
    assert got.dtype == want.dtype and got.shape == want.shape == (t, d)
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=tol, atol=tol * float(want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d,f", [(16, 2048, 8192), (4, 3584, 14336), (300, 2048, 8192)])
def test_cuda_swiglu_is_deterministic(cuda_device, dtype, t, d, f):
    """The K-split partials are summed in slice order, never by atomics:
    two runs give the same bits."""
    args = _swiglu_inputs(cuda_device, dtype, t, d, f, seed=4)
    assert torch.equal(tgk.swiglu(*args), tgk.swiglu(*args))
