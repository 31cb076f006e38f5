"""Jackson open queueing network model (paper Eq. 3 + traffic equations).

``routing[i][j] = p`` means a tuple finishing at operator *i* produces an
input to operator *j* with expected multiplicity ``p``.  Per-operator
arrival rates solve ``lam = lam0 + P^T lam``, and the end-to-end expected
sojourn is ``E[T](k) = (1/lam0_total) * sum_i lam_i * E[T_i](k_i)``.
Host-side float64 spec code.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from .erlang import expected_sojourn, min_stable_k

__all__ = ["OperatorSpec", "Topology", "UnstableTopologyError", "solve_traffic_equations"]


class UnstableTopologyError(ValueError):
    """Routing matrix has spectral radius >= 1 (a loop that does not leak)."""


@dataclass(frozen=True)
class OperatorSpec:
    """One operator: per-processor service rate ``mu`` and how k processors
    compose -- ``"replica"`` (M/M/k) or ``"group"`` (one gang at
    ``mu * k * eff(k)``, ``eff(k) = 1 / (1 + group_alpha * (k - 1))``)."""

    name: str
    mu: float
    scaling: str = "replica"
    group_alpha: float = 0.0
    min_k: int = 1
    max_k: int = 1 << 30

    def sojourn(self, k: int, lam: float) -> float:
        """E[T_i](k) for this operator under arrival rate lam."""
        if k < self.min_k:
            return math.inf
        if self.scaling == "replica":
            return expected_sojourn(k, lam, self.mu)
        if self.scaling == "group":
            eff = 1.0 / (1.0 + self.group_alpha * (k - 1))
            return expected_sojourn(1, lam, self.mu * k * eff)
        raise ValueError(f"unknown scaling {self.scaling!r}")

    def min_feasible_k(self, lam: float) -> int:
        """Smallest k with finite sojourn (Algorithm 1 line 2 init)."""
        if self.scaling == "replica":
            return max(self.min_k, min_stable_k(lam, self.mu))
        # A gang's rate asymptotes at mu/alpha: beyond it no k is stable.
        if self.group_alpha > 0 and lam >= self.mu / self.group_alpha:
            raise UnstableTopologyError(
                f"operator {self.name}: group scaling saturates at "
                f"mu/alpha = {self.mu / self.group_alpha:.3g} < lam = {lam:.3g}; "
                "no chip count can keep this stage stable"
            )
        k = self.min_k
        while not math.isfinite(self.sojourn(k, lam)):
            k += 1
            if k > self.max_k:
                raise UnstableTopologyError(
                    f"operator {self.name}: no feasible k <= max_k={self.max_k} "
                    f"for lam={lam}, mu={self.mu} (group_alpha={self.group_alpha})"
                )
        return k


def solve_traffic_equations(lam0, routing, *, check_stability: bool = True) -> np.ndarray:
    """Solve lam = lam0 + P^T lam for lam (Jackson traffic equations)."""
    lam0 = np.asarray(lam0, dtype=np.float64)
    p = np.asarray(routing, dtype=np.float64)
    n = lam0.shape[0]
    if p.shape != (n, n):
        raise ValueError(f"routing must be ({n},{n}), got {p.shape}")
    if np.any(p < 0):
        raise ValueError("routing probabilities/multiplicities must be >= 0")
    if check_stability:
        radius = max(abs(np.linalg.eigvals(p)))
        if radius >= 1.0 - 1e-12:
            raise UnstableTopologyError(
                f"routing spectral radius {radius:.6f} >= 1; a loop must leak "
                "probability for the open network to be stable"
            )
    lam = np.linalg.solve(np.eye(n) - p.T, lam0)
    # Numerical noise can produce tiny negatives for zero-traffic operators.
    lam[np.abs(lam) < 1e-12] = 0.0
    if np.any(lam < 0):
        raise UnstableTopologyError(f"negative solved arrival rates: {lam}")
    return lam


@dataclass
class Topology:
    """Operator network: specs + external arrivals + routing."""

    operators: list[OperatorSpec]
    lam0: np.ndarray  # external arrival rate per operator
    routing: np.ndarray  # routing[i][j] = expected tuples to j per tuple done at i
    _lam: np.ndarray | None = field(default=None, repr=False)

    def __post_init__(self) -> None:
        self.lam0 = np.asarray(self.lam0, dtype=np.float64)
        self.routing = np.asarray(self.routing, dtype=np.float64)
        n = len(self.operators)
        if self.lam0.shape != (n,):
            raise ValueError(f"lam0 must have shape ({n},), got {self.lam0.shape}")
        if self.routing.shape != (n, n):
            raise ValueError(f"routing must have shape ({n},{n}), got {self.routing.shape}")

    @property
    def n(self) -> int:
        return len(self.operators)

    @property
    def lam0_total(self) -> float:
        return float(self.lam0.sum())

    @property
    def arrival_rates(self) -> np.ndarray:
        """Per-operator arrival rates lam_i from the traffic equations."""
        if self._lam is None:
            self._lam = solve_traffic_equations(self.lam0, self.routing)
        return self._lam

    @property
    def visit_counts(self) -> np.ndarray:
        """Expected visits to each operator per external tuple: lam_i / lam0."""
        return self.arrival_rates / max(self.lam0_total, 1e-300)

    def expected_sojourn(self, k) -> float:
        """E[T](k) -- paper Eq. (3); 0 for an idle network."""
        k = np.asarray(k)
        if k.shape != (self.n,):
            raise ValueError(f"k must have shape ({self.n},), got {k.shape}")
        lam = self.arrival_rates
        total = 0.0
        for i, op in enumerate(self.operators):
            if lam[i] == 0.0:
                continue
            t = op.sojourn(int(k[i]), lam[i])
            if math.isinf(t):
                return math.inf
            total += lam[i] * t
        return total / max(self.lam0_total, 1e-300)

    def min_feasible_allocation(self) -> np.ndarray:
        """Algorithm 1 lines 1-3: k_i = ceil(lam_i/mu_i) (stability-bumped)."""
        lam = self.arrival_rates
        return np.array(
            [op.min_feasible_k(lam[i]) for i, op in enumerate(self.operators)],
            dtype=np.int64,
        )
