"""Dispatch: the CUDA kernel for CUDA tensors (through
:class:`~.grad.FlashAttentionFn` when an input requires grad), the plain
version for CPU tensors (which autograd differentiates directly), and for
meta tensors an empty output with the kernel's work charged to the active
cost trace (:func:`~repro_torch.kernels.cost.meta_kernel`)."""

from __future__ import annotations

import torch

from .. import cost
from . import kernel as _kernel, ref as _ref
from .grad import FlashAttentionFn

__all__ = ["attention"]


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              scale: float | None = None):
    """q [B, H, Sq, Dh], k / v [B, Hkv, Skv, Dh] -> [B, H, Sq, Dh]."""
    if q.is_cuda:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttentionFn.apply(q, k, v, causal, window, scale)
        return _kernel.attention(q, k, v, causal=causal, window=window, scale=scale)
    if q.is_meta:
        b, h, sq, dh = q.shape
        dims = dict(b=b, hq=h, hkv=k.shape[1], sq=sq, skv=k.shape[2], dh=dh, causal=causal,
                    window=window, size=q.element_size())
        out, = cost.meta_kernel("flash_attention", (q, k, v), [((b, sq, h, dh), q.dtype)], dims)
        return out.transpose(1, 2)
    return _ref.attention(q, k, v, causal=causal, window=window, scale=scale)
