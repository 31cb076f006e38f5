"""Heterogeneous-processor extension (paper §III-A: "the proposed models
and algorithms can also support settings with heterogeneous processors"),
the counterpart of ``repro/core/heterogeneous.py`` (numpy float64).

The pool offers processors in speed classes (e.g. older and newer card
generations, big and little host cores).  A processor of speed s serves at
s * mu_i on operator i.  An operator holding processors with speeds {s_1..s_k}
is approximated as k homogeneous servers at the MEAN speed -- exact when the
speeds within one operator are equal, a standard approximation otherwise
(heterogeneous M/M/k has no closed form).  To keep the approximation tight
the allocator draws speeds fastest first, so operators tend to hold
contiguous speed bands.

The greedy stays optimal per step by Theorem 1's convexity argument given
the fastest-first draw order; a global optimality proof does not carry over.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .allocator import InsufficientResourcesError
from .erlang import expected_sojourn
from .jackson import Topology

__all__ = ["SpeedPool", "HeterogeneousAllocation", "assign_heterogeneous"]


@dataclass(frozen=True)
class SpeedPool:
    """Inventory of processors by speed class, e.g. {1.0: 16, 0.5: 8}."""

    counts: tuple[tuple[float, int], ...]  # ((speed, n), ...) fastest first

    @staticmethod
    def of(d: dict[float, int]) -> "SpeedPool":
        return SpeedPool(tuple(sorted(d.items(), reverse=True)))

    @property
    def total(self) -> int:
        return sum(n for _, n in self.counts)

    def draws(self) -> list[float]:
        """All speeds, fastest first."""
        out: list[float] = []
        for s, n in self.counts:
            out.extend([s] * n)
        return out


@dataclass
class HeterogeneousAllocation:
    speeds: list[list[float]]  # per-operator assigned speeds
    expected_sojourn: float

    @property
    def k(self) -> np.ndarray:
        return np.array([len(s) for s in self.speeds], dtype=np.int64)

    def effective_mu(self, base_mu: list[float]) -> list[float]:
        return [
            base_mu[i] * (float(np.mean(s)) if s else 1.0)
            for i, s in enumerate(self.speeds)
        ]


def _op_sojourn(op_mu: float, speeds: list[float], lam: float) -> float:
    """E[T_i] under the mean-speed M/M/k approximation."""
    k = len(speeds)
    if k == 0:
        return math.inf
    mu_eff = op_mu * float(np.mean(speeds))
    return expected_sojourn(k, lam, mu_eff)


def assign_heterogeneous(
    top: Topology, pool: SpeedPool
) -> HeterogeneousAllocation:
    """Greedy Algorithm-1 analogue drawing processors fastest-first.

    Initialisation mirrors Algorithm 1 lines 1-4: give each operator
    fastest-remaining processors until it is stable; raise
    InsufficientResourcesError if the pool runs dry first.  Then spend the
    remainder by maximum marginal benefit (delta recomputed per step with
    the next available speed).
    """
    lam = top.arrival_rates
    draws = pool.draws()  # fastest first
    speeds: list[list[float]] = [[] for _ in range(top.n)]

    # stabilisation: repeatedly give the fastest remaining processor to the
    # operator whose capacity deficit costs the most processor-equivalents
    # (deficit / (mu_i * s_next)) — the aggregator's small mu-relative
    # deficit never outbids the heavy bolts for the fast units.
    def deficit(i: int, s_next: float) -> float:
        cap = top.operators[i].mu * sum(speeds[i])
        return (lam[i] - cap) / (top.operators[i].mu * s_next)

    while True:
        if all(deficit(i, 1.0) < 0 for i in range(top.n) if lam[i] > 0):
            break
        if not draws:
            raise InsufficientResourcesError(pool.total + 1, pool.total, np.array(
                [len(s) for s in speeds]))
        s_next = draws[0]
        worst = max(
            (i for i in range(top.n) if lam[i] > 0), key=lambda i: deficit(i, s_next)
        )
        speeds[worst].append(draws.pop(0))

    # greedy spend of the remainder
    while draws:
        s_next = draws[0]
        best_i, best_delta = -1, 0.0
        for i in range(top.n):
            if lam[i] == 0:
                continue
            t0 = _op_sojourn(top.operators[i].mu, speeds[i], lam[i])
            t1 = _op_sojourn(top.operators[i].mu, speeds[i] + [s_next], lam[i])
            delta = lam[i] * (t0 - t1)
            if delta > best_delta:
                best_delta, best_i = delta, i
        if best_i < 0:
            break  # nothing benefits
        speeds[best_i].append(draws.pop(0))

    total = 0.0
    for i in range(top.n):
        if lam[i] == 0:
            continue
        t = _op_sojourn(top.operators[i].mu, speeds[i], lam[i])
        if math.isinf(t):
            return HeterogeneousAllocation(speeds, math.inf)
        total += lam[i] * t
    return HeterogeneousAllocation(speeds, total / top.lam0_total)
