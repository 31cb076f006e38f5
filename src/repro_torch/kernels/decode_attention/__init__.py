"""Single-token attention over a KV cache (kernel / plain version /
dispatch)."""

from .ops import decode_attention

__all__ = ["decode_attention"]
