"""Rebalance mechanics: executable cache + migration cost model, the live
path's copy of ``repro/core/rebalance.py``.

The paper's cheap rebalance swaps only the resized operators' workers.
:class:`ExecutableCache` keeps compiled executables keyed by (stage, k,
signature) so a return to a seen configuration is a lookup; the
:class:`RebalanceCostModel` prices a proposed move for the scheduler's
Appendix B-B cost/benefit call:

    pause      -- control-plane pause (cache hit vs miss)
    migration  -- state bytes moved over the link bandwidth
    backlog    -- a pause of P seconds queues lam0 * P tuples, which drain
                  at (capacity - lam0) tuples/sec.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

__all__ = ["ExecutableCache", "RebalanceCostModel", "RebalancePlan"]


@dataclass
class _CacheEntry:
    value: Any
    compile_seconds: float
    hits: int = 0


class ExecutableCache:
    """Cache of compiled executables keyed by (stage, k, signature)."""

    def __init__(self, compile_fn: Callable[[str, int, Any], Any] | None = None):
        self._store: dict[tuple, _CacheEntry] = {}
        self._compile_fn = compile_fn
        self.hits = 0
        self.misses = 0

    def key(self, stage: str, k: int, signature: Any = None) -> tuple:
        return (stage, int(k), signature)

    def get(self, stage: str, k: int, signature: Any = None) -> Any | None:
        e = self._store.get(self.key(stage, k, signature))
        if e is not None:
            e.hits += 1
            self.hits += 1
            return e.value
        self.misses += 1
        return None

    def put(self, stage: str, k: int, value: Any, *, signature: Any = None, compile_seconds: float = 0.0) -> None:
        self._store[self.key(stage, k, signature)] = _CacheEntry(value, compile_seconds)

    def get_or_compile(self, stage: str, k: int, signature: Any = None) -> Any:
        hit = self.get(stage, k, signature)
        if hit is not None:
            return hit
        if self._compile_fn is None:
            raise KeyError(f"no cached executable for {(stage, k, signature)}")
        t0 = time.perf_counter()
        v = self._compile_fn(stage, k, signature)
        self.put(stage, k, v, signature=signature, compile_seconds=time.perf_counter() - t0)
        return v

    def warm_neighbours(self, stage: str, k: int, signature: Any = None, radius: int = 1) -> int:
        """Pre-compile k±radius configurations off the critical path."""
        if self._compile_fn is None:
            return 0
        n = 0
        for kk in range(max(1, k - radius), k + radius + 1):
            if self.get(stage, kk, signature) is None:
                self.get_or_compile(stage, kk, signature)
                n += 1
        return n

    def __len__(self) -> int:
        return len(self._store)


@dataclass(frozen=True)
class RebalancePlan:
    """A priced proposal to move from allocation k_old to k_new."""

    k_old: np.ndarray
    k_new: np.ndarray
    pause_seconds: float
    migration_seconds: float
    backlog_drain_seconds: float
    benefit_per_second: float  # E[T](k_old) - E[T](k_new), seconds saved per tuple

    @property
    def total_cost_seconds(self) -> float:
        return self.pause_seconds + self.migration_seconds + self.backlog_drain_seconds

    def worthwhile(self, horizon_seconds: float, lam0: float) -> bool:
        """Cost/benefit over a planning horizon (paper Appendix B-B).

        Benefit ~ tuples processed over the horizon * per-tuple seconds
        saved; cost ~ the one-off disruption (pause + migration + drain).
        """
        if np.array_equal(self.k_old, self.k_new):
            return False
        gain = self.benefit_per_second * lam0 * horizon_seconds
        return gain > self.total_cost_seconds * max(lam0, 1.0)


@dataclass
class RebalanceCostModel:
    """Prices a rebalance for the scheduler's decision.

    ici_bandwidth: per-processor link bandwidth used for state migration.
    pause_cache_hit / pause_cache_miss: control-plane pause depending on
    whether every new (stage, k) executable is already cached.
    """

    ici_bandwidth: float = 50e9
    # The paper's improved rebalance "takes a few seconds" vs Storm's 1-2
    # minutes; our executable cache makes a hit sub-second, and background
    # neighbour warm-up (ExecutableCache.warm_neighbours) keeps most misses
    # off the critical path, so the default miss pause is seconds.
    pause_cache_hit: float = 0.5
    pause_cache_miss: float = 5.0
    state_bytes_per_processor: np.ndarray | None = None  # per-operator

    def plan(
        self,
        topology,
        k_old: np.ndarray,
        k_new: np.ndarray,
        *,
        cache: ExecutableCache | None = None,
        stage_names: list[str] | None = None,
    ) -> RebalancePlan:
        k_old = np.asarray(k_old)
        k_new = np.asarray(k_new)
        changed = np.nonzero(k_old != k_new)[0]
        # Pause: cache hit if every changed stage's new executable is cached.
        pause = self.pause_cache_hit
        if cache is not None and stage_names is not None:
            for i in changed:
                if cache.get(stage_names[i], int(k_new[i])) is None:
                    pause = self.pause_cache_miss
                    break
        elif cache is None:
            pause = self.pause_cache_miss if len(changed) else self.pause_cache_hit
        # Migration: bytes proportional to |delta k| per operator.
        mig = 0.0
        if self.state_bytes_per_processor is not None:
            delta = np.abs(k_new - k_old).astype(np.float64)
            mig = float((delta * self.state_bytes_per_processor).sum()) / self.ici_bandwidth
        # Backlog drain: lam0*pause extra tuples drained at (capacity - lam0).
        et_old = topology.expected_sojourn(k_old)
        et_new = topology.expected_sojourn(k_new)
        lam0 = topology.lam0_total
        mus = np.array([op.mu for op in topology.operators])
        capacity_new = float(np.min(k_new * mus / np.maximum(topology.visit_counts, 1e-12)))
        slack = max(capacity_new - lam0, 1e-9)
        drain = lam0 * (pause + mig) / slack
        benefit = (et_old - et_new) if np.isfinite(et_old) else float("inf")
        return RebalancePlan(k_old, k_new, pause, mig, drain, benefit)
