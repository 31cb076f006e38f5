"""Dispatch: the CUDA kernels for CUDA tensors, the plain versions for CPU."""

from __future__ import annotations

from . import kernel as _kernel, ref as _ref

__all__ = ["queue_step", "queue_window"]


def queue_step(q, inflow, cap_serve, cap_queue):
    """[M] queue lanes -> (q_next, served, dropped)."""
    if q.is_cuda:
        return _kernel.queue_step(q, inflow, cap_serve, cap_queue)
    return _ref.queue_step(q, inflow, cap_serve, cap_queue)


def queue_window(q, served_prev, ext, warm, cap_serve, cap_queue, routing):
    """One control window of [B, N] queue lanes -> the 15 window outputs
    (``ref.queue_window``)."""
    fn = _kernel.queue_window if q.is_cuda else _ref.queue_window
    return fn(q, served_prev, ext, warm, cap_serve, cap_queue, routing)
