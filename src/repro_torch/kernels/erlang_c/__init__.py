"""Erlang-B recurrence table (kernel / plain version / dispatch)."""

from .ops import erlang_b_table

__all__ = ["erlang_b_table"]
