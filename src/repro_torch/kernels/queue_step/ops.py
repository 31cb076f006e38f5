"""Dispatch: the CUDA kernel for CUDA tensors, the plain version for CPU."""

from __future__ import annotations

from . import kernel as _kernel, ref as _ref

__all__ = ["queue_step"]


def queue_step(q, inflow, cap_serve, cap_queue):
    """[M] queue lanes -> (q_next, served, dropped)."""
    if q.is_cuda:
        return _kernel.queue_step(q, inflow, cap_serve, cap_queue)
    return _ref.queue_step(q, inflow, cap_serve, cap_queue)
