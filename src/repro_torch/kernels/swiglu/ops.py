"""Dispatch: the CUDA kernels for CUDA tensors (through
:class:`~.grad.SwiGLUFn` when an input requires grad), the plain version
for CPU tensors (which autograd differentiates directly)."""

from __future__ import annotations

import torch

from . import kernel as _kernel, ref as _ref
from .grad import SwiGLUFn

__all__ = ["swiglu"]


def swiglu(x, wg, wu, wo):
    """x [T, D], wg / wu [D, F], wo [F, D] -> (silu(x wg) * (x wu)) wo [T, D]."""
    if x.is_cuda:
        if torch.is_grad_enabled() and any(t.requires_grad for t in (x, wg, wu, wo)):
            return SwiGLUFn.apply(x, wg, wu, wo)
        return _kernel.swiglu(x, wg, wu, wo)
    return _ref.swiglu(x, wg, wu, wo)
