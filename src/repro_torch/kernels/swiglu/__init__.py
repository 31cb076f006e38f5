"""The SwiGLU feed-forward (kernel / plain version / dispatch)."""

from .ops import swiglu

__all__ = ["swiglu"]
