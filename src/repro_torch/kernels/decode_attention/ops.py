"""Dispatch: the CUDA kernel for CUDA tensors, the plain version for CPU."""

from __future__ import annotations

from . import kernel as _kernel, ref as _ref

__all__ = ["decode_attention"]


def decode_attention(q, k_cache, v_cache, length, *, window: int | None = None,
                     scale: float | None = None):
    """q [B, H, Dh], caches [B, S, Hkv, Dh], valid prefix ``length`` -> [B, H, Dh]."""
    if q.is_cuda:
        return _kernel.decode_attention(q, k_cache, v_cache, length, window=window,
                                        scale=scale)
    return _ref.decode_attention(q, k_cache, v_cache, length, window=window, scale=scale)
