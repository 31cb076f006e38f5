"""Autograd of the flash attention kernel for the training forward.

:class:`FlashAttentionFn`'s forward is the CUDA kernel as it runs for
serving (the plain version for CPU tensors) and keeps only q, k and v;
its backward is autograd of the plain version (``ref.py``) recomputed on
them (:func:`~repro_torch.kernels._autograd.plain_backward`), so one
layer's float32 score block lives only during that layer's backward.  A
hand-written backward kernel is speed work.
"""

from __future__ import annotations

import torch

from .._autograd import plain_backward
from . import kernel as _kernel, ref as _ref

__all__ = ["FlashAttentionFn"]


class FlashAttentionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window, scale):
        ctx.save_for_backward(q, k, v)
        ctx.opts = {"causal": causal, "window": window, "scale": scale}
        fwd = _kernel.attention if q.is_cuda else _ref.attention
        return fwd(q, k, v, **ctx.opts)

    @staticmethod
    def backward(ctx, grad_out):
        grads = plain_backward(_ref.attention, ctx.saved_tensors, ctx.needs_input_grad[:3],
                               grad_out, **ctx.opts)
        return (*grads, None, None, None)
