"""Fused batch decide: table -> gains -> Program 4 -> E[T] gathers
(kernel / plain version / dispatch)."""

from .ops import batch_decide

__all__ = ["batch_decide"]
