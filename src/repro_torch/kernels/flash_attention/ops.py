"""Dispatch: the CUDA kernel for CUDA tensors, the plain version for CPU."""

from __future__ import annotations

from . import kernel as _kernel, ref as _ref

__all__ = ["attention"]


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              scale: float | None = None):
    """q [B, H, Sq, Dh], k / v [B, Hkv, Skv, Dh] -> [B, H, Sq, Dh]."""
    if q.is_cuda:
        return _kernel.attention(q, k, v, causal=causal, window=window, scale=scale)
    return _ref.attention(q, k, v, causal=causal, window=window, scale=scale)
