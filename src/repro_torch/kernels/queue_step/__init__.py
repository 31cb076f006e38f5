"""Bounded-queue fluid step and control window (kernel / plain version /
dispatch)."""

from .ops import queue_step, queue_window

__all__ = ["queue_step", "queue_window"]
