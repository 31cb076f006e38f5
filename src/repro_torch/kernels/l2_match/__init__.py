"""Squared L2 distances and fused match counts, the VLD matcher's compute
(kernel / plain version / dispatch)."""

from .ops import match_count, pairwise_sq_l2

__all__ = ["pairwise_sq_l2", "match_count"]
