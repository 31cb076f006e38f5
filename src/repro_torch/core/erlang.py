"""Erlang M/M/k sojourn-time model (paper Eq. 1-2), scalar float64.

Operator *i* with ``k`` identical processors, Poisson arrivals at ``lam``
and exponential service at ``mu`` per processor is an M/M/k queue with

    E[T](k) = ErlangC(k, a) / (k*mu - lam) + 1/mu,      a = lam/mu,

computed through the stable Erlang-B recursion ``B(0)=1; B(k) =
a*B(k-1) / (k + a*B(k-1))`` and the B->C conversion.  ``math.inf`` marks an
unstable operator (``k*mu <= lam``).  Host-side spec code: the scenario
planner and the reports price single allocations with it.
:func:`expected_sojourn_factorial` is the paper's Eq. (1)-(2) as written,
with explicit factorials (it overflows past k ~ 170): the oracle for small
k.  :func:`marginal_benefit` is Algorithm 1's line 9.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

__all__ = ["erlang_b", "erlang_c", "expected_sojourn", "expected_queue_delay",
           "expected_sojourn_factorial", "min_stable_k", "sojourn_curve", "marginal_benefit",
           "cached_sojourn"]


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


def expected_queue_delay(k: int, lam: float, mu: float) -> float:
    """Expected time spent waiting in queue only, E[W] = E[T] - 1/mu."""
    t = expected_sojourn(k, lam, mu)
    return t - 1.0 / mu if math.isfinite(t) else math.inf


def expected_sojourn_factorial(k: int, lam: float, mu: float) -> float:
    """Paper Eq. (1)-(2) with explicit factorials (the oracle for small k;
    prefer :func:`expected_sojourn`)."""
    if lam == 0.0:
        return 1.0 / mu
    a = lam / mu
    if k <= a:
        return math.inf
    rho = a / k
    # pi_0 per Eq. (2)
    s = sum(a**j / math.factorial(j) for j in range(k))
    s += a**k / (math.factorial(k) * (1.0 - rho))
    pi0 = 1.0 / s
    wait = (a**k) * pi0 / (math.factorial(k) * (1.0 - rho) ** 2 * mu * k)
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


def sojourn_curve(lam: float, mu: float, k_lo: int, k_hi: int) -> np.ndarray:
    """E[T](k) for k in [k_lo, k_hi], from one pass of the B recursion."""
    if k_lo < 0 or k_hi < k_lo:
        raise ValueError(f"bad range [{k_lo}, {k_hi}]")
    if lam == 0.0:
        return np.full(k_hi - k_lo + 1, 1.0 / mu)
    a = lam / mu
    out = np.empty(k_hi - k_lo + 1, dtype=np.float64)
    b = 1.0
    for j in range(1, k_hi + 1):
        b = a * b / (j + a * b)
        if j >= k_lo:
            if j <= a:
                out[j - k_lo] = math.inf
            else:
                c = j * b / (j - a * (1.0 - b))
                out[j - k_lo] = c / (j * mu - lam) + 1.0 / mu
    if k_lo == 0:
        out[0] = math.inf
    return out


def marginal_benefit(k: int, lam: float, mu: float) -> float:
    """delta(k) = lam * (E[T](k) - E[T](k+1)), Algorithm 1 line 9;
    non-increasing in k (paper Ineq. 5), +inf where E[T](k) is infinite."""
    t_k = expected_sojourn(k, lam, mu)
    t_k1 = expected_sojourn(k + 1, lam, mu)
    if math.isinf(t_k):
        return math.inf
    return lam * (t_k - t_k1)


@lru_cache(maxsize=65536)
def _cached_sojourn(k: int, lam: float, mu: float) -> float:
    return expected_sojourn(k, lam, mu)


def cached_sojourn(k: int, lam: float, mu: float) -> float:
    """Memoised E[T](k)."""
    return _cached_sojourn(k, float(lam), float(mu))
