"""Dispatch: the CUDA kernel for CUDA tensors, the plain version for CPU.

Every stream keeps its own bonus ``u``.  (The JAX package's CPU dispatch,
``repro/kernels/rwkv6_scan/ops.py:17``, passes ``u[:1]`` and so applies
stream 0's bonus to every stream; the port does not copy that.)"""

from __future__ import annotations

import torch

from . import kernel as _kernel, ref as _ref

__all__ = ["rwkv6_scan"]


def rwkv6_scan(r, k, v, lw, u, s0=None, *, chunk: int = 32):
    """r / k / lw [..., S, Dk], v [..., S, Dv], u [..., Dk], s0 [..., Dk,
    Dv] or None -> (o [..., S, Dv] in r's dtype, S_T float32)."""
    if r.is_cuda:
        if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in (r, k, v, lw, u, s0)):
            raise NotImplementedError(
                "rwkv6_scan: the CUDA kernel has no autograd Function yet, so its inputs would "
                "get no gradient (ssm / hybrid training, ROADMAP Queue 1 item 7)")
        return _kernel.rwkv6_scan(r, k, v, lw, u, s0, chunk=chunk)
    return _ref.rwkv6_scan(r, k, v, lw, u, s0, chunk=chunk)
