"""Dispatch: the CUDA kernel for CUDA tensors, the plain version for CPU."""

from __future__ import annotations

from . import kernel as _kernel, ref as _ref

__all__ = ["gain_topr"]


def gain_topr(cand, budget):
    """[B, N, J] candidate gains + [B] budgets -> [B, N] int32 takes."""
    if cand.is_cuda:
        return _kernel.gain_topr(cand, budget)
    return _ref.gain_topr(cand, budget)
