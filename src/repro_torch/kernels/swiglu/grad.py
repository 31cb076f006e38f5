"""Autograd of the SwiGLU kernels for the training forward.

:class:`SwiGLUFn`'s forward is the CUDA kernels as they run for serving
(the plain version for CPU tensors) and keeps x and the three weights;
its backward is autograd of the plain version (``ref.py``) recomputed on
them (:func:`~repro_torch.kernels._autograd.plain_backward`).  A
hand-written backward kernel is speed work.
"""

from __future__ import annotations

import torch

from .._autograd import plain_backward
from . import kernel as _kernel, ref as _ref

__all__ = ["SwiGLUFn"]


class SwiGLUFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wg, wu, wo):
        ctx.save_for_backward(x, wg, wu, wo)
        return (_kernel.swiglu if x.is_cuda else _ref.swiglu)(x, wg, wu, wo)

    @staticmethod
    def backward(ctx, grad_out):
        return tuple(plain_backward(_ref.swiglu, ctx.saved_tensors, ctx.needs_input_grad,
                                    grad_out))
