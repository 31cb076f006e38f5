"""The port's LLM CUDA kernels against their plain PyTorch versions, on the
card.

These tests need a CUDA device and skip without one (the kernels have no
CPU mode).  They import no JAX, so they also run where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_llm_kernels_cuda.py

Attention: kernel and plain version both compute in float32 and round the
output once, so in bf16 they may differ by one ulp, 2^-7 of the largest
value in the output row; the limit is two ulps.  In float32 the limit,
2e-5 * (1 + |plain|), sits above summation-order noise and below what one
key too many or too few moves an output.  SwiGLU: the plain version rounds
the gate and up products to bf16, the kernel rounds their silu product
once, so bf16 is held to 5e-2 of the output's magnitude.
"""

from __future__ import annotations

import pytest
import torch

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv,window", [(200, 200, None), (128, 300, None), (256, 256, 64)])
def test_cuda_flash_matches_plain(cuda_device, dtype, sq, skv, window):
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 8, sq, 64, generator=gen).to(cuda_device, dtype)
    k = torch.randn(2, 2, skv, 64, generator=gen).to(cuda_device, dtype)
    v = torch.randn(2, 2, skv, 64, generator=gen).to(cuda_device, dtype)
    got = tfk.attention(q, k, v, causal=True, window=window)
    want = tfr.attention(q, k, v, causal=True, window=window)
    assert got.dtype == want.dtype and got.shape == want.shape
    _assert_attention_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length,window", [(1, None), (1000, None), (1000, 100)])
def test_cuda_decode_matches_plain(cuda_device, dtype, length, window):
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(3, 8, 64, generator=gen).to(cuda_device, dtype)
    k = torch.randn(3, 1024, 2, 64, generator=gen).to(cuda_device, dtype)
    v = torch.randn(3, 1024, 2, 64, generator=gen).to(cuda_device, dtype)
    n = torch.tensor(length, dtype=torch.int32, device=cuda_device)
    got = tdk.decode_attention(q, k, v, n, window=window)
    want = tdr.decode_attention(q, k, v, n, window=window)
    assert got.dtype == want.dtype and got.shape == want.shape
    _assert_attention_close(got, want)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-3), (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("t", [1, 200])
def test_cuda_swiglu_matches_plain(cuda_device, dtype, tol, t):
    gen = torch.Generator().manual_seed(2)
    d, f = 256, 520
    x = torch.randn(t, d, generator=gen).to(cuda_device, dtype)
    wg, wu = (torch.randn(d, f, generator=gen).div(d ** 0.5).to(cuda_device, dtype)
              for _ in range(2))
    wo = torch.randn(f, d, generator=gen).div(f ** 0.5).to(cuda_device, dtype)
    got = tgk.swiglu(x, wg, wu, wo).float()
    want = tgr.swiglu(x, wg, wu, wo).float()
    torch.testing.assert_close(got, want, rtol=tol, atol=tol * float(want.abs().max()))
