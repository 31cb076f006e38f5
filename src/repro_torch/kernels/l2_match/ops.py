"""Dispatch: the CUDA kernels for CUDA tensors, the plain versions for CPU."""

from __future__ import annotations

from . import kernel as _kernel, ref as _ref

__all__ = ["pairwise_sq_l2", "match_count"]


def pairwise_sq_l2(a, b):
    """[M, D] x [N, D] -> [M, N] squared L2 distances."""
    if a.is_cuda:
        return _kernel.pairwise_sq_l2(a, b)
    return _ref.pairwise_sq_l2(a, b)


def match_count(a, b, threshold: float, valid=None):
    """[M, D] queries, [N, D] library, optional [M] mask -> int32 [N] counts."""
    if a.is_cuda:
        return _kernel.match_count(a, b, threshold, valid)
    return _ref.match_count(a, b, threshold, valid)
