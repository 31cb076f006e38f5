"""Plain PyTorch version of the Erlang-B recurrence table."""

from __future__ import annotations

import torch

__all__ = ["erlang_b_table"]


def erlang_b_table(a, *, k_hi: int):
    """[S] offered loads -> [k_hi+1, S] table ``B(j) = a B(j-1) / (j + a
    B(j-1))`` with row 0 all ones; the dtype follows ``a``."""
    rows = [torch.ones_like(a)]
    b = rows[0]
    for j in range(1, k_hi + 1):
        ab = a * b
        b = ab / (ab + float(j))
        rows.append(b)
    return torch.stack(rows, dim=0)
