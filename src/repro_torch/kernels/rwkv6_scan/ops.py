"""Dispatch: the CUDA kernel for CUDA tensors (through
:class:`~.grad.Rwkv6ScanFn` when an input requires grad), the plain
version for CPU tensors (which autograd differentiates directly), and for
meta tensors empty outputs with the kernel's work charged to the active cost
trace (:func:`~repro_torch.kernels.cost.meta_kernel`).

Every stream keeps its own bonus ``u``.  (The JAX package's CPU dispatch,
``repro/kernels/rwkv6_scan/ops.py:17``, passes ``u[:1]`` and so applies
stream 0's bonus to every stream; the port does not copy that.)"""

from __future__ import annotations

import math

import torch

from .. import cost
from . import kernel as _kernel, ref as _ref
from .grad import Rwkv6ScanFn

__all__ = ["rwkv6_scan"]


def rwkv6_scan(r, k, v, lw, u, s0=None, *, chunk: int = 32):
    """r / k / lw [..., S, Dk], v [..., S, Dv], u [..., Dk], s0 [..., Dk,
    Dv] or None -> (o [..., S, Dv] in r's dtype, S_T float32)."""
    if r.is_cuda:
        if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in (r, k, v, lw, u, s0)):
            return Rwkv6ScanFn.apply(r, k, v, lw, u, s0, chunk)
        return _kernel.rwkv6_scan(r, k, v, lw, u, s0, chunk=chunk)
    if r.is_meta:
        *lead, s, dk = r.shape
        dv = v.shape[-1]
        dims = dict(kind="rwkv6", b=r.shape[0], h=math.prod(lead[1:]), s=s,
                    dk=dk, dv=dv, chunk=chunk, size=r.element_size())
        return cost.meta_kernel("rwkv6_scan", (r, k, v, lw, u, s0),
                                [((*lead, s, dv), r.dtype), ((*lead, dk, dv), torch.float32)],
                                dims)
    return _ref.rwkv6_scan(r, k, v, lw, u, s0, chunk=chunk)
