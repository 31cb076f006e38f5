"""Dispatch: the CUDA kernel for CUDA tensors, the plain version for CPU,
and for meta tensors an empty output with the kernel's work charged to the
active cost trace (:func:`~repro_torch.kernels.cost.meta_kernel`).  A meta
``length`` has no value: the charge is a query at the cache's last row,
which reads the whole cache (the window's keys under a window)."""

from __future__ import annotations

from .. import cost
from . import kernel as _kernel, ref as _ref

__all__ = ["decode_attention"]


def decode_attention(q, k_cache, v_cache, length, *, window: int | None = None,
                     scale: float | None = None):
    """q [B, H, Dh], caches [B, S, Hkv, Dh], valid prefix ``length`` -> [B, H, Dh]."""
    if q.is_cuda:
        return _kernel.decode_attention(q, k_cache, v_cache, length, window=window,
                                        scale=scale)
    if q.is_meta:
        b, h, dh = q.shape
        dims = dict(b=b, hq=h, hkv=k_cache.shape[2], dh=dh, s_max=k_cache.shape[1],
                    window=window, size=q.element_size())
        return cost.meta_kernel("decode_attention", (q, k_cache, v_cache),
                                [((b, h, dh), q.dtype)], dims)[0]
    return _ref.decode_attention(q, k_cache, v_cache, length, window=window, scale=scale)
