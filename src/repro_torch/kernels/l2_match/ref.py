"""Plain PyTorch version of the l2_match kernels.

    d2[i, j] = max((|a_i|^2 + |b_j|^2) - 2 * (a_i . b_j), 0)
    count[j] = #{ i : valid[i] and d2[i, j] <= t2 }

The norms and the cross term are each accumulated over the descriptor
dimension in order, one elementwise multiply and one add per step -- the
CUDA kernel's operation order, so on the card the two agree bitwise (a
BLAS product or a tree reduction would sum in another order).  ``t2`` is
``threshold * threshold`` squared in double and rounded once to float32,
as ``repro/kernels/l2_match/ref.py`` compares it.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["pairwise_sq_l2", "match_count", "squared_threshold"]


def squared_threshold(threshold: float) -> float:
    """``threshold ** 2`` rounded once to float32 (as a Python float)."""
    return float(np.float32(float(threshold) * float(threshold)))


def pairwise_sq_l2(a, b):
    """[M, D] x [N, D] float32 -> [M, N] float32 squared L2 distances."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    m, d = a.shape
    n = b.shape[0]
    a2 = torch.zeros(m, dtype=torch.float32, device=a.device)
    b2 = torch.zeros(n, dtype=torch.float32, device=a.device)
    cross = torch.zeros((m, n), dtype=torch.float32, device=a.device)
    for k in range(d):
        ak, bk = a[:, k], b[:, k]
        a2 = a2 + ak * ak
        b2 = b2 + bk * bk
        cross = cross + ak[:, None] * bk[None, :]
    return torch.clamp_min((a2[:, None] + b2[None, :]) - 2.0 * cross, 0.0)


def match_count(a, b, threshold: float, valid=None):
    """Per library row of ``b``, the number of (valid) rows of ``a`` within
    L2 distance ``threshold``: int32 [N]."""
    d2 = pairwise_sq_l2(a, b)
    t2 = torch.tensor(squared_threshold(threshold), dtype=torch.float32, device=d2.device)
    hits = d2 <= t2
    if valid is not None:
        hits = hits & valid.to(torch.bool)[:, None]
    return hits.sum(dim=0).to(torch.int32)
