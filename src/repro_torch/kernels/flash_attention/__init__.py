"""Causal / windowed / bidirectional online-softmax attention
(kernel / plain version / dispatch)."""

from .ops import attention

__all__ = ["attention"]
