"""Dispatch: the CUDA kernel for CUDA tensors (through
:class:`~.grad.SsdScanFn` when an input requires grad), the plain version
for CPU tensors (which autograd differentiates directly), and for meta
tensors empty outputs with the kernel's work charged to the active cost
trace (:func:`~repro_torch.kernels.cost.meta_kernel`; B and C read once
per batch row when they are views expanded over the heads)."""

from __future__ import annotations

import math

import torch

from .. import cost
from . import kernel as _kernel, ref as _ref
from .grad import SsdScanFn

__all__ = ["ssd_scan"]


def ssd_scan(x, a, b, c, s0=None, *, chunk: int = 64):
    """x [..., S, Dh], a [..., S], b / c [..., S, Dst], s0 [..., Dst, Dh]
    or None -> (y [..., S, Dh] in x's dtype, S_T float32)."""
    if x.is_cuda:
        if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in (x, a, b, c, s0)):
            return SsdScanFn.apply(x, a, b, c, s0, chunk)
        return _kernel.ssd_scan(x, a, b, c, s0, chunk=chunk)
    if x.is_meta:
        *lead, s, dh = x.shape
        dst = b.shape[-1]
        dims = dict(kind="ssd", b=x.shape[0], h=math.prod(lead[1:]), s=s,
                    dk=dst, dv=dh, chunk=chunk, size=x.element_size(),
                    shared_bc=b.ndim == 4 and b.stride(1) == 0)
        return cost.meta_kernel("ssd_scan", (x, a, b, c, s0),
                                [((*lead, s, dh), x.dtype), ((*lead, dst, dh), torch.float32)],
                                dims)
    return _ref.ssd_scan(x, a, b, c, s0, chunk=chunk)
