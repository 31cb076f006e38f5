"""DRS resource allocation -- Programs (4) and (6).

Program (4) (min E[T] s.t. sum k_i <= K_max) is the paper's Algorithm 1
greedy, either collapsed to a top-R selection over the ``[N, K]``
marginal-gain table (:func:`assign_processors_table`) or walked with a
max-heap of each operator's next gain (:func:`assign_processors`); the two
give the same allocation.  Program (6) (min sum k_i s.t. E[T] <= T_max)
bisects the greedy's nested increment count on the table
(:func:`min_processors_table`) or runs the heap greedy until the bound
holds (:func:`min_processors`).  :func:`allocate` dispatches between
Programs (4) and (6).  :func:`assign_processors_naive` is Algorithm 1 as
the paper writes it (every round prices every operator's marginal benefit
and increments the argmax) and :func:`brute_force_optimal` enumerates
Program (4) on tiny instances: the two oracles the others are held to.
Host-side float64 spec code, as in ``repro/core/allocator.py``.
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass

import numpy as np

from .batched import gain_table
from .jackson import Topology

__all__ = [
    "InsufficientResourcesError",
    "AllocationResult",
    "assign_processors",
    "assign_processors_naive",
    "brute_force_optimal",
    "min_processors",
    "candidate_window",
    "greedy_increments",
    "assign_processors_table",
    "min_processors_table",
    "allocate",
]


class InsufficientResourcesError(RuntimeError):
    """Paper Algorithm 1 lines 4-6: sum of minimal k_i exceeds K_max."""

    def __init__(self, needed: int, k_max: int, k_min: np.ndarray):
        super().__init__(
            f"minimum feasible allocation needs {needed} processors but "
            f"K_max={k_max} (per-operator minima: {k_min.tolist()})"
        )
        self.needed = needed
        self.k_max = k_max
        self.k_min = k_min


@dataclass(frozen=True)
class AllocationResult:
    k: np.ndarray  # processors per operator
    expected_sojourn: float  # model E[T](k), seconds
    total: int  # sum k_i
    evaluations: int  # materialised table entries (cost metric)


def _marginal(top: Topology, lam: np.ndarray, i: int, k_i: int) -> float:
    """delta_i = lam_i * (E[T_i](k_i) - E[T_i](k_i+1)), Algorithm 1 line 9."""
    op = top.operators[i]
    t0 = op.sojourn(k_i, lam[i])
    t1 = op.sojourn(k_i + 1, lam[i])
    if math.isinf(t0):
        return math.inf
    return lam[i] * (t0 - t1)


def assign_processors_naive(top: Topology, k_max: int) -> AllocationResult:
    """Paper Algorithm 1, literal transcription (the oracle)."""
    lam = top.arrival_rates
    k = top.min_feasible_allocation()
    evals = 0
    if int(k.sum()) > k_max:
        raise InsufficientResourcesError(int(k.sum()), k_max, k)
    while int(k.sum()) < k_max:
        deltas = np.empty(top.n)
        for i in range(top.n):
            deltas[i] = _marginal(top, lam, i, int(k[i]))
            evals += 2
        j = int(np.argmax(deltas))
        if deltas[j] <= 0.0:
            break  # no operator benefits
        k[j] += 1
    return AllocationResult(k, top.expected_sojourn(k), int(k.sum()), evals)


def assign_processors(top: Topology, k_max: int) -> AllocationResult:
    """Heap-based Algorithm 1 — identical output, O((K-K0) log N)."""
    lam = top.arrival_rates
    k = top.min_feasible_allocation()
    evals = 0
    total = int(k.sum())
    if total > k_max:
        raise InsufficientResourcesError(total, k_max, k)
    # Max-heap of (-delta, i); each operator's entry reflects its next gain.
    heap: list[tuple[float, int]] = []
    for i in range(top.n):
        if lam[i] == 0.0:
            continue
        d = _marginal(top, lam, i, int(k[i]))
        evals += 2
        heap.append((-d, i))
    heapq.heapify(heap)
    while total < k_max and heap:
        neg_d, i = heapq.heappop(heap)
        if -neg_d <= 0.0:
            break
        k[i] += 1
        total += 1
        d = _marginal(top, lam, i, int(k[i]))
        evals += 2
        heapq.heappush(heap, (-d, i))
    return AllocationResult(k, top.expected_sojourn(k), total, evals)


def _heap_greedy_counts(cand: np.ndarray, budget: int) -> np.ndarray:
    """Exact argmax-greedy walk over a candidate-gain matrix (used when the
    float gain rows are not non-increasing, so prefix selection is unsafe)."""
    n, width = cand.shape
    take = np.zeros(n, dtype=np.int64)
    heap = [(-float(cand[i, 0]), i) for i in range(n) if width > 0]
    heapq.heapify(heap)
    while budget > 0 and heap:
        neg_d, i = heapq.heappop(heap)
        if -neg_d <= 0.0:
            break
        take[i] += 1
        budget -= 1
        if take[i] < width:
            heapq.heappush(heap, (-float(cand[i, take[i]]), i))
    return take


def candidate_window(G: np.ndarray, k_start: np.ndarray, budget: int) -> np.ndarray:
    """The ``[n, budget]`` gains the greedy can reach: row i from its start
    column ``k_start[i]`` (the batched planner selects from the same
    window)."""
    idx = k_start[:, None] + np.arange(budget)[None, :]
    if idx.max() >= G.shape[1]:
        raise ValueError(
            f"gain table too narrow: need column {int(idx.max())}, have {G.shape[1]}"
        )
    return G[np.arange(G.shape[0])[:, None], idx]


def greedy_increments(G: np.ndarray, k_start: np.ndarray, budget: int) -> np.ndarray:
    """How many of ``budget`` processors each operator receives when they are
    handed out one at a time to the largest current gain ``G[i, k]`` from
    ``k_start[i]``: the globally largest ``budget`` positive entries, with
    threshold ties resolved in (operator index, k) order -- Algorithm 1's
    argmax loop decision for decision."""
    n = G.shape[0]
    if budget <= 0:
        return np.zeros(n, dtype=np.int64)
    cand = candidate_window(G, k_start, budget)
    if np.any(cand[:, 1:] > cand[:, :-1]):
        return _heap_greedy_counts(cand, budget)
    pos = cand > 0.0
    pos_counts = pos.sum(axis=1).astype(np.int64)
    if int(pos_counts.sum()) <= budget:
        return pos_counts  # every beneficial processor fits in the budget
    vals = cand[pos]
    thresh = np.partition(vals, len(vals) - budget)[len(vals) - budget]
    take = (cand > thresh).sum(axis=1).astype(np.int64)
    rem = budget - int(take.sum())
    if rem > 0:
        ties = ((cand == thresh) & pos).sum(axis=1)
        for i in range(n):
            if rem == 0:
                break
            t = min(int(ties[i]), rem)
            take[i] += t
            rem -= t
    return take


def assign_processors_table(top: Topology, k_max: int) -> AllocationResult:
    """Program (4) via the precomputed ``[N, K]`` marginal-gain table."""
    k = top.min_feasible_allocation()
    total = int(k.sum())
    if total > k_max:
        raise InsufficientResourcesError(total, k_max, k)
    budget = k_max - total
    if budget == 0:
        return AllocationResult(k, top.expected_sojourn(k), total, 0)
    k_hi = int(k.max()) + budget
    T, G = gain_table(top, k_hi)
    k = k + greedy_increments(G, k.astype(np.int64), budget)
    return AllocationResult(k, top.expected_sojourn(k), int(k.sum()), T.size)


def min_processors_table(top: Topology, t_max: float, *, k_cap: int = 1 << 20
                         ) -> AllocationResult:
    """Program (6) on the gain table: binary-search the increment count of
    the nested greedy allocations (E[T] is non-increasing along them)."""
    lam = top.arrival_rates
    floor = sum(
        lam[i] / top.lam0_total / op.mu for i, op in enumerate(top.operators) if lam[i] > 0
    )
    if t_max < floor:
        raise InsufficientResourcesError(k_cap, k_cap, top.min_feasible_allocation())
    k0 = top.min_feasible_allocation()
    total0 = int(k0.sum())
    et0 = top.expected_sojourn(k0)
    if et0 <= t_max:
        return AllocationResult(k0, et0, total0, 0)
    evals = 0
    budget = 256
    while True:
        budget = min(budget, max(k_cap - total0, 0))
        k_hi = int(k0.max()) + budget
        T, G = gain_table(top, k_hi)
        evals += T.size
        take_full = greedy_increments(G, k0.astype(np.int64), budget)
        k_full = k0 + take_full
        et_full = top.expected_sojourn(k_full)
        if et_full <= t_max:
            lo, hi = 1, int(take_full.sum())  # hi is feasible; find minimal m
            while lo < hi:
                mid = (lo + hi) // 2
                k_mid = k0 + greedy_increments(G, k0.astype(np.int64), mid)
                if top.expected_sojourn(k_mid) <= t_max:
                    hi = mid
                else:
                    lo = mid + 1
            k = k0 + greedy_increments(G, k0.astype(np.int64), lo)
            return AllocationResult(k, top.expected_sojourn(k), int(k.sum()), evals)
        exhausted = int(take_full.sum()) < budget  # no positive gains left
        if exhausted or budget >= k_cap - total0:
            raise InsufficientResourcesError(int(k_full.sum()), k_cap, k_full)
        budget *= 4


def min_processors(
    top: Topology, t_max: float, *, k_cap: int = 1 << 20
) -> AllocationResult:
    """Program (6): min sum k_i s.t. E[T](k) <= T_max (greedy, paper §III-C).

    Starts from the minimal feasible allocation and adds the max-marginal-
    benefit processor until the constraint holds.  ``k_cap`` bounds the
    search (raises if T_max is unreachable, e.g. below the service-time
    floor sum_i v_i / mu_i which no amount of processors can beat).
    """
    lam = top.arrival_rates
    # Constraint floor: E[T] >= sum_i (lam_i/lam0) * (1/mu_i) even with k=inf.
    floor = sum(
        lam[i] / top.lam0_total / op.mu for i, op in enumerate(top.operators) if lam[i] > 0
    )
    if t_max < floor:
        raise InsufficientResourcesError(
            k_cap, k_cap, top.min_feasible_allocation()
        )
    k = top.min_feasible_allocation()
    evals = 0
    heap: list[tuple[float, int]] = []
    for i in range(top.n):
        if lam[i] == 0.0:
            continue
        d = _marginal(top, lam, i, int(k[i]))
        evals += 2
        heap.append((-d, i))
    heapq.heapify(heap)
    et = top.expected_sojourn(k)
    total = int(k.sum())
    while et > t_max and heap and total < k_cap:
        neg_d, i = heapq.heappop(heap)
        gain = -neg_d
        if gain <= 0.0:
            break
        k[i] += 1
        total += 1
        # E[T] drops by lam_i * gain / lam0 (Eq. 3 weighting) — an O(1)
        # running estimate that accumulates float error over thousands of
        # increments, so it only steers the loop; feasibility is judged on
        # the exactly recomputed value below.
        et -= gain / top.lam0_total
        d = _marginal(top, lam, i, int(k[i]))
        evals += 2
        heapq.heappush(heap, (-d, i))
    # Re-derive the true E[T](k): near T_max the drifted running value can
    # mis-accept (accept/raise must use the same model the caller sees).
    et = top.expected_sojourn(k)
    while et > t_max and heap and total < k_cap:
        # Drift made the loop exit one (or a few) processors early: keep
        # adding by exact marginal benefit until the true E[T] satisfies
        # the constraint or no processor helps.
        neg_d, i = heapq.heappop(heap)
        if -neg_d <= 0.0:
            break
        k[i] += 1
        total += 1
        et = top.expected_sojourn(k)
        d = _marginal(top, lam, i, int(k[i]))
        evals += 2
        heapq.heappush(heap, (-d, i))
    if et > t_max:
        raise InsufficientResourcesError(total, k_cap, k)
    return AllocationResult(k, et, total, evals)


def allocate(top: Topology, *, k_max: int | None = None, t_max: float | None = None
             ) -> AllocationResult:
    """Program (6) when ``t_max`` is given (falling back to Program (4) at
    ``k_max`` when it needs more), else Program (4) at ``k_max``."""
    if k_max is None and t_max is None:
        raise ValueError("need k_max and/or t_max")
    if t_max is not None:
        try:
            res = min_processors_table(top, t_max)
            if k_max is None or res.total <= k_max:
                return res
        except InsufficientResourcesError:
            if k_max is None:
                raise
    assert k_max is not None
    return assign_processors_table(top, k_max)


def brute_force_optimal(top: Topology, k_max: int) -> tuple[np.ndarray, float]:
    """Exhaustive Program (4) for tests (tiny instances only)."""
    k_min = top.min_feasible_allocation()
    if int(k_min.sum()) > k_max:
        raise InsufficientResourcesError(int(k_min.sum()), k_max, k_min)
    best_k, best_t = None, math.inf
    n = top.n

    def rec(i: int, remaining: int, k: list[int]) -> None:
        nonlocal best_k, best_t
        if i == n:
            t = top.expected_sojourn(np.array(k))
            if t < best_t:
                best_t, best_k = t, np.array(k)
            return
        for extra in range(remaining + 1):
            rec(i + 1, remaining - extra, k + [int(k_min[i]) + extra])

    rec(0, k_max - int(k_min.sum()), [])
    assert best_k is not None
    return best_k, best_t
