"""Dispatch: the CUDA kernels for CUDA tensors, the plain version for CPU."""

from __future__ import annotations

from . import kernel as _kernel, ref as _ref

__all__ = ["swiglu"]


def swiglu(x, wg, wu, wo):
    """x [T, D], wg / wu [D, F], wo [F, D] -> (silu(x wg) * (x wu)) wo [T, D]."""
    if x.is_cuda:
        return _kernel.swiglu(x, wg, wu, wo)
    return _ref.swiglu(x, wg, wu, wo)
