"""Plain PyTorch version of the fused batch-decide pass.

``batch_decide`` runs the decide's model chain -- sojourn table,
Algorithm-1 gains, minimal feasible allocation, Program-4 budget-th-largest
selection, and the ``E[T]``-at-allocation gathers -- as one function of the
solved per-lane rates.  It is composed from the same expressions as the
two-pass decide in ``core/controller.py`` (the plain sojourn table and the
plain ``gain_topr``), so the fused and two-pass decides agree bit for bit
wherever both run their plain versions.

``j_cap`` truncates each lane's candidate window to the first ``j_cap``
gains past ``k_start``.  Per-lane gains are non-increasing (paper Ineq. 5),
so no lane can take more than ``budget <= j_cap`` increments and the
selection, ties included, is unchanged; callers guarantee ``budget <=
j_cap`` (the controller passes the fleet-wide ``max(k_max)``).
"""

from __future__ import annotations

import torch

from ...core.batched import sojourn_table_torch
from ..gain_topr import ref as topr_ref

__all__ = ["batch_decide"]


def batch_decide(lam, mu_eff, *, group, alpha, active, k_cur, k_max, k_hi: int,
                 j_cap: int | None = None):
    """``[B, N]`` solved rates -> ``(k4, k_start, t_cur, t4)``.

    ``lam`` are the solved (active-masked, clamped) per-operator arrival
    rates, ``mu_eff`` the speed-scaled service rates, ``k_cur`` the
    allocation in force and ``k_max [B]`` the budgets.  Returns the
    Program-4 allocation ``k4 [B, N]`` int32, the minimal feasible
    allocation ``k_start [B, N]`` int32 (``k_hi + 1`` = infeasible lane),
    and the per-operator sojourns ``T[k_cur]`` / ``T[k4]`` in ``lam``'s
    dtype.
    """
    b, n = lam.shape
    dev = lam.device
    T = sojourn_table_torch(
        lam.reshape(-1), mu_eff.reshape(-1), k_hi=k_hi,
        group=group.reshape(-1), alpha=alpha.reshape(-1),
        min_k=torch.ones(b * n, dtype=torch.int32, device=dev), plain=True,
    ).reshape(b, n, k_hi + 1)
    G = lam[..., None] * (T[..., :-1] - T[..., 1:])
    G = torch.where(torch.isfinite(T[..., :-1]), G, float("inf"))

    finite = torch.isfinite(T)
    has_finite = finite.any(dim=-1)
    # torch.argmax takes no bool tensors on the CPU; uint8 keeps "first
    # maximum" semantics.
    first = torch.argmax(finite.to(torch.uint8), dim=-1).to(torch.int32)
    k_start = torch.where(
        active, torch.where(has_finite, first, k_hi + 1), 0
    ).to(torch.int32)
    floor_total = k_start.sum(dim=-1)

    budget = torch.clamp_min(k_max.to(torch.int64) - floor_total, 0).to(torch.int32)
    jc = k_hi if j_cap is None else max(min(int(j_cap), k_hi), 1)
    j = torch.arange(jc, dtype=torch.int64, device=dev)
    idx = k_start[..., None].to(torch.int64) + j[None, None, :]
    cand = torch.gather(G, -1, torch.clamp(idx, 0, k_hi - 1))
    cand = torch.where(
        (idx < k_hi) & active[..., None] & torch.isfinite(cand), cand, 0.0
    )
    take = topr_ref.gain_topr(cand, budget)
    k4 = k_start + take

    def _gather(k_vec):
        return torch.gather(
            T, -1, torch.clamp(k_vec.to(torch.int64), 0, k_hi)[..., None]
        )[..., 0]

    return k4, k_start, _gather(k_cur), _gather(k4)
