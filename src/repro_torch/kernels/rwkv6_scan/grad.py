"""Autograd of the RWKV6 scan kernel for the training forward.

:class:`Rwkv6ScanFn`'s forward is the CUDA kernel as it runs for serving
(the plain version for CPU tensors) and keeps only its inputs r, k, v,
lw, u and s0; its backward is autograd of the plain version (``ref.py``)
against the gradients of both outputs, ``o`` and ``S_T``, recomputed on
them (:func:`~repro_torch.kernels._autograd.plain_backward`).  So one
layer's ``[..., C, C, Dk]`` decay blocks live only during that layer's
backward.  ``u`` may broadcast over the leading dims (``[H, Dk]`` for
``[B, H]`` streams); its gradient comes back in its own shape.  The JAX
package trains through its plain chunked scan, with no backward kernel; a
hand-written one is speed work.
"""

from __future__ import annotations

import torch

from .._autograd import plain_backward
from . import kernel as _kernel, ref as _ref

__all__ = ["Rwkv6ScanFn"]


class Rwkv6ScanFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, lw, u, s0, chunk: int):
        ctx.set_materialize_grads(False)  # an unused output's gradient stays None
        ctx.save_for_backward(r, k, v, lw, u, s0)
        ctx.chunk = chunk
        fwd = _kernel.rwkv6_scan if r.is_cuda else _ref.rwkv6_scan
        return fwd(r, k, v, lw, u, s0, chunk=chunk)

    @staticmethod
    def backward(ctx, grad_o, grad_state):
        grads = plain_backward(_ref.rwkv6_scan, ctx.saved_tensors, ctx.needs_input_grad[:6],
                               (grad_o, grad_state), chunk=ctx.chunk)
        return (*grads, None)
