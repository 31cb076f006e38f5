"""Erlang M/M/k sojourn-time model (paper Eq. 1-2), scalar float64.

Operator *i* with ``k`` identical processors, Poisson arrivals at ``lam``
and exponential service at ``mu`` per processor is an M/M/k queue with

    E[T](k) = ErlangC(k, a) / (k*mu - lam) + 1/mu,      a = lam/mu,

computed through the stable Erlang-B recursion ``B(0)=1; B(k) =
a*B(k-1) / (k + a*B(k-1))`` and the B->C conversion.  ``math.inf`` marks an
unstable operator (``k*mu <= lam``).  Host-side spec code: the scenario
planner and the reports price single allocations with it.
"""

from __future__ import annotations

import math

__all__ = ["erlang_b", "erlang_c", "expected_sojourn", "min_stable_k"]


def erlang_b(k: int, a: float) -> float:
    """Erlang-B blocking probability B(k, a) via the stable recursion."""
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    if a < 0:
        raise ValueError(f"offered load a must be >= 0, got {a}")
    b = 1.0
    for j in range(1, k + 1):
        b = a * b / (j + a * b)
    return b


def erlang_c(k: int, a: float) -> float:
    """Erlang-C probability that an arrival must wait (valid for a < k)."""
    if a >= k:
        return 1.0  # degenerate; callers guard stability separately
    b = erlang_b(k, a)
    return k * b / (k - a * (1.0 - b))


def expected_sojourn(k: int, lam: float, mu: float) -> float:
    """E[T](k) for an M/M/k operator; +inf when ``k*mu <= lam``."""
    if mu <= 0:
        raise ValueError(f"service rate mu must be > 0, got {mu}")
    if lam < 0:
        raise ValueError(f"arrival rate lam must be >= 0, got {lam}")
    if lam == 0.0:
        return 1.0 / mu
    a = lam / mu
    if k <= a:  # k*mu <= lam
        return math.inf
    c = erlang_c(k, a)
    wait = c / (k * mu - lam)
    return wait + 1.0 / mu


def min_stable_k(lam: float, mu: float) -> int:
    """Smallest k with finite E[T]: ceil(lam/mu), bumped when lam/mu is
    integral (k*mu == lam is unstable)."""
    if lam == 0.0:
        return 1
    a = lam / mu
    k = math.ceil(a)
    if k <= a:  # a integral
        k += 1
    return max(k, 1)
