"""Bounded-queue fluid step (kernel / plain version / dispatch)."""

from .ops import queue_step

__all__ = ["queue_step"]
