"""Autograd of the SSD scan kernel for the training forward.

:class:`SsdScanFn`'s forward is the CUDA kernel as it runs for serving
(the plain version for CPU tensors) and keeps only its inputs x, a, b, c
and s0; its backward is autograd of the plain version (``ref.py``)
against the gradients of both outputs, ``y`` and ``S_T``, recomputed on
them (:func:`~repro_torch.kernels._autograd.plain_backward`).  zamba2's
B and C are ``expand``ed views shared by the heads: they are saved as the
views (a copy would cost 112x), their gradients come back in the views'
full shape, and autograd sums them over the heads through the
``expand``.  The JAX package trains through its plain chunked scan, with
no backward kernel; a hand-written one is speed work.
"""

from __future__ import annotations

import torch

from .._autograd import plain_backward
from . import kernel as _kernel, ref as _ref

__all__ = ["SsdScanFn"]


class SsdScanFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, b, c, s0, chunk: int):
        ctx.set_materialize_grads(False)  # an unused output's gradient stays None
        ctx.save_for_backward(x, a, b, c, s0)
        ctx.chunk = chunk
        fwd = _kernel.ssd_scan if x.is_cuda else _ref.ssd_scan
        return fwd(x, a, b, c, s0, chunk=chunk)

    @staticmethod
    def backward(ctx, grad_y, grad_state):
        grads = plain_backward(_ref.ssd_scan, ctx.saved_tensors, ctx.needs_input_grad[:5],
                               (grad_y, grad_state), chunk=ctx.chunk)
        return (*grads, None)
