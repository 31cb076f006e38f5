"""Dispatch: the CUDA kernel for CUDA tensors, the plain version for CPU."""

from __future__ import annotations

from . import kernel as _kernel, ref as _ref

__all__ = ["erlang_b_table"]


def erlang_b_table(a, *, k_hi: int):
    """[S] offered loads -> [k_hi+1, S] Erlang-B blocking table."""
    if a.is_cuda:
        return _kernel.erlang_b_table(a, k_hi=k_hi)
    return _ref.erlang_b_table(a, k_hi=k_hi)
