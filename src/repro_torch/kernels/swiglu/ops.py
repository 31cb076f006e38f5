"""Dispatch: the CUDA kernels for CUDA tensors (through
:class:`~.grad.SwiGLUFn` when an input requires grad), the plain version
for CPU tensors (which autograd differentiates directly), and for meta
tensors an empty output with the kernel's work charged to the active cost
trace (:func:`~repro_torch.kernels.cost.meta_kernel`)."""

from __future__ import annotations

import torch

from .. import cost
from . import kernel as _kernel, ref as _ref
from .grad import SwiGLUFn

__all__ = ["swiglu"]


def swiglu(x, wg, wu, wo):
    """x [T, D], wg / wu [D, F], wo [F, D] -> (silu(x wg) * (x wu)) wo [T, D]."""
    if x.is_cuda:
        if torch.is_grad_enabled() and any(t.requires_grad for t in (x, wg, wu, wo)):
            return SwiGLUFn.apply(x, wg, wu, wo)
        return _kernel.swiglu(x, wg, wu, wo)
    if x.is_meta:
        (t, d), f = x.shape, wg.shape[1]
        dims = dict(t=t, d=d, f=f, size=x.element_size())
        return cost.meta_kernel("swiglu", (x, wg, wu, wo), [((t, wo.shape[1]), x.dtype)],
                                dims)[0]
    return _ref.swiglu(x, wg, wu, wo)
