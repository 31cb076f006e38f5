"""Plain PyTorch version of the batched top-R gain selection (a sort).

``cand[b, i, j]`` is the marginal benefit of operator *i*'s *j*-th extra
processor in scenario *b* (masked entries are 0).  Each scenario hands out
``budget[b]`` processors to its largest *positive* gains; every row is
non-increasing (paper Ineq. 5), so this equals the scalar greedy's argmax
walk, with threshold ties resolved in operator order
(``allocator.greedy_increments``'s rule):

    take[b, i] = #{j : cand[b, i, j] > theta_b} + ties at theta_b,
                 handed out row-major until the budget is exact,

where ``theta_b`` is the budget-th largest positive gain.
"""

from __future__ import annotations

import torch

__all__ = ["gain_topr"]


def gain_topr(cand, budget):
    """``cand [B, N, J]`` gains + ``budget [B]`` -> ``take [B, N]`` int32."""
    b, n, j = cand.shape
    budget = budget.to(torch.int64)
    pos = cand > 0
    pos_row = pos.sum(dim=-1)
    use_all = pos_row.sum(dim=-1) <= budget
    flat = torch.where(pos, cand, float("-inf")).reshape(b, n * j)
    vals = torch.sort(flat, dim=-1, descending=True).values
    idx = torch.clamp(budget - 1, 0, max(n * j - 1, 0))
    if n * j:
        thresh = torch.gather(vals, 1, idx[:, None])[:, 0]
    else:
        thresh = torch.full((b,), float("-inf"), dtype=cand.dtype, device=cand.device)
    strict = ((cand > thresh[:, None, None]) & pos).sum(dim=-1)
    ties = ((cand == thresh[:, None, None]) & pos).sum(dim=-1)
    rem = budget - strict.sum(dim=-1)
    before = torch.cumsum(ties, dim=-1) - ties
    extra = torch.clamp_min(torch.minimum(ties, rem[:, None] - before), 0)
    take = torch.where(use_all[:, None], pos_row, strict + extra)
    return torch.where(budget[:, None] > 0, take, 0).to(torch.int32)
