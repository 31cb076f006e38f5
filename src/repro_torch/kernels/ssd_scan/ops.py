"""Dispatch: the CUDA kernel for CUDA tensors, the plain version for CPU."""

from __future__ import annotations

import torch

from . import kernel as _kernel, ref as _ref

__all__ = ["ssd_scan"]


def ssd_scan(x, a, b, c, s0=None, *, chunk: int = 64):
    """x [..., S, Dh], a [..., S], b / c [..., S, Dst], s0 [..., Dst, Dh]
    or None -> (y [..., S, Dh] in x's dtype, S_T float32)."""
    if x.is_cuda:
        if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in (x, a, b, c, s0)):
            raise NotImplementedError(
                "ssd_scan: the CUDA kernel has no autograd Function yet, so its inputs would "
                "get no gradient (ssm / hybrid training, ROADMAP Queue 1 item 7)")
        return _kernel.ssd_scan(x, a, b, c, s0, chunk=chunk)
    return _ref.ssd_scan(x, a, b, c, s0, chunk=chunk)
