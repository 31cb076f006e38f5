"""Batched masked top-R gain selection (kernel / plain version / dispatch)."""

from .ops import gain_topr

__all__ = ["gain_topr"]
