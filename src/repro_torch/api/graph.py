"""Declarative application graphs -- the topology surface.

:class:`OpDef` declares one operator (service-rate prior, scaling mode),
:class:`Edge` one directed edge with an expected multiplicity (``> 1`` is
fan-out, a self-loop below 1 leaks).  :class:`AppGraph` validates at
construction -- unknown endpoints, duplicate names or edges, negative rates
and non-leaking loops raise -- and compiles to the routing matrix, the
external-arrival vector and a :class:`~repro_torch.core.jackson.Topology`.
An operator's ``fn`` is its live-engine compute; :meth:`AppGraph.bind`
returns a :class:`~repro_torch.api.session.DRSSession` on the discrete-event
simulator (``"des"``, the default) or the live engine (``"engine"``) -- the
port of ``repro/api/graph.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Mapping, Sequence

import numpy as np

from ..core.jackson import OperatorSpec, Topology, UnstableTopologyError

__all__ = ["OpDef", "Edge", "AppGraph", "GraphValidationError"]


class GraphValidationError(ValueError):
    """The graph declaration is malformed (bad names, edges, or rates)."""


@dataclass(frozen=True)
class OpDef:
    """One operator: ``mu`` is the per-processor service-rate prior; ``fn``
    the live-engine compute, ``fn(payload) -> list[(downstream_name,
    payload)]`` (``None`` for model-only graphs); ``scaling`` is
    ``"replica"`` (M/M/k) or ``"group"`` (a gang at ``mu * k * eff(k)``);
    ``service_kind`` / ``service_cv`` choose the DES service-time law."""

    name: str
    mu: float
    fn: Callable[[Any], list[tuple[str, Any]]] | None = None
    scaling: str = "replica"
    group_alpha: float = 0.0
    min_k: int = 1
    max_k: int = 1 << 30
    service_kind: str = "exponential"
    service_cv: float = 1.0

    def spec(self, mu: float | None = None) -> OperatorSpec:
        """Compile to the core model's operator description."""
        return OperatorSpec(
            name=self.name, mu=self.mu if mu is None else mu, scaling=self.scaling,
            group_alpha=self.group_alpha, min_k=self.min_k, max_k=self.max_k,
        )


@dataclass(frozen=True)
class Edge:
    """Directed edge ``src -> dst`` with expected multiplicity."""

    src: str
    dst: str
    multiplicity: float = 1.0


class AppGraph:
    """A validated operator network: ops + edges + external sources."""

    def __init__(
        self,
        ops: Sequence[OpDef],
        edges: Sequence[Edge] = (),
        sources: Mapping[str, float] | None = None,
        *,
        arrival_kind: str = "exponential",
        validate_stability: bool = True,
    ):
        self.ops: tuple[OpDef, ...] = tuple(ops)
        self.edges: tuple[Edge, ...] = tuple(edges)
        self.arrival_kind = arrival_kind
        self.validate_stability = validate_stability
        if not self.ops:
            raise GraphValidationError("graph needs at least one operator")
        self.names: list[str] = [op.name for op in self.ops]
        if len(set(self.names)) != len(self.names):
            dupes = sorted({n for n in self.names if self.names.count(n) > 1})
            raise GraphValidationError(f"duplicate operator names: {dupes}")
        self.index: dict[str, int] = {n: i for i, n in enumerate(self.names)}
        for op in self.ops:
            if op.mu <= 0:
                raise GraphValidationError(
                    f"operator {op.name!r}: service rate mu must be > 0, got {op.mu}"
                )
            if op.scaling not in ("replica", "group"):
                raise GraphValidationError(
                    f"operator {op.name!r}: unknown scaling {op.scaling!r}"
                )

        n = len(self.ops)
        self._routing = np.zeros((n, n), dtype=np.float64)
        for e in self.edges:
            for endpoint in (e.src, e.dst):
                if endpoint not in self.index:
                    raise GraphValidationError(
                        f"edge {e.src!r} -> {e.dst!r}: unknown operator {endpoint!r}"
                    )
            if e.multiplicity <= 0:
                raise GraphValidationError(
                    f"edge {e.src!r} -> {e.dst!r}: multiplicity must be > 0, "
                    f"got {e.multiplicity}"
                )
            i, j = self.index[e.src], self.index[e.dst]
            if self._routing[i, j] != 0.0:
                raise GraphValidationError(f"duplicate edge {e.src!r} -> {e.dst!r}")
            self._routing[i, j] = e.multiplicity

        self._lam0 = np.zeros(n, dtype=np.float64)
        for name, rate in (sources or {}).items():
            if name not in self.index:
                raise GraphValidationError(f"unknown source operator {name!r}")
            if rate < 0:
                raise GraphValidationError(
                    f"source {name!r}: arrival rate must be >= 0, got {rate}"
                )
            self._lam0[self.index[name]] = rate

        if validate_stability:
            radius = self.spectral_radius
            if radius >= 1.0 - 1e-12:
                raise UnstableTopologyError(
                    f"routing spectral radius {radius:.6f} >= 1; every cycle "
                    "must leak probability for the open network to be stable"
                )

    @property
    def n(self) -> int:
        return len(self.ops)

    @property
    def spectral_radius(self) -> float:
        return float(max(abs(np.linalg.eigvals(self._routing))))

    @property
    def source_names(self) -> list[str]:
        return [n for n, r in zip(self.names, self._lam0) if r > 0]

    def op(self, name: str) -> OpDef:
        return self.ops[self.index[name]]

    def routing_matrix(self) -> np.ndarray:
        """The derived routing matrix P (``P[i][j]`` = multiplicity i->j)."""
        return self._routing.copy()

    def lam0_vector(self) -> np.ndarray:
        """External arrival rates in operator-index order."""
        return self._lam0.copy()

    def k_vector(self, k) -> np.ndarray:
        """Allocation as an index-ordered int vector (accepts dict or seq)."""
        if isinstance(k, Mapping):
            missing = [n for n in self.names if n not in k]
            if missing:
                raise GraphValidationError(f"allocation missing operators: {missing}")
            extra = sorted(set(k) - set(self.names))
            if extra:
                raise GraphValidationError(f"allocation has unknown operators: {extra}")
            return np.array([int(k[n]) for n in self.names], dtype=np.int64)
        vec = np.asarray(k, dtype=np.int64)
        if vec.shape != (self.n,):
            raise GraphValidationError(
                f"allocation must have shape ({self.n},), got {vec.shape}"
            )
        return vec.copy()

    def k_dict(self, k) -> dict[str, int]:
        """Allocation as a name-keyed dict (accepts dict or seq)."""
        return dict(zip(self.names, self.k_vector(k).tolist()))

    def topology(self, mu: Mapping[str, float] | None = None) -> Topology:
        """Compile to the Jackson-network model (``mu`` overrides priors by
        operator name)."""
        overrides = dict(mu or {})
        unknown = set(overrides) - set(self.names)
        if unknown:
            raise GraphValidationError(f"mu overrides for unknown operators: {sorted(unknown)}")
        specs = [op.spec(overrides.get(op.name)) for op in self.ops]
        return Topology(specs, self._lam0.copy(), self._routing.copy())

    def scaling_lists(self) -> tuple[list[str], list[float]]:
        """(scaling mode, group_alpha) per operator, index-ordered."""
        return [op.scaling for op in self.ops], [op.group_alpha for op in self.ops]

    def with_sources(self, sources: Mapping[str, float]) -> "AppGraph":
        """Same graph, different external arrival rates."""
        return AppGraph(
            self.ops, self.edges, sources, arrival_kind=self.arrival_kind,
            validate_stability=self.validate_stability,
        )

    def with_fns(self, fns: Mapping[str, Callable]) -> "AppGraph":
        """Same graph with compute fns attached (model-only -> runnable)."""
        unknown = set(fns) - set(self.names)
        if unknown:
            raise GraphValidationError(f"fns for unknown operators: {sorted(unknown)}")
        ops = [replace(op, fn=fns.get(op.name, op.fn)) for op in self.ops]
        return AppGraph(
            ops, self.edges, dict(zip(self.names, self._lam0.tolist())),
            arrival_kind=self.arrival_kind, validate_stability=self.validate_stability,
        )

    def bind(self, backend: Any = "des", **kwargs):
        """Bind this graph to a backend: :meth:`DRSSession.bind
        <repro_torch.api.session.DRSSession.bind>`."""
        from .session import DRSSession  # session imports this module

        return DRSSession.bind(self, backend, **kwargs)

    @staticmethod
    def chain(names_mus: Sequence[tuple[str, float]], lam0: float, *,
              arrival_kind: str = "exponential") -> "AppGraph":
        """A linear chain: external tuples enter op0, op_i feeds op_{i+1}
        (the VLD shape)."""
        ops = [OpDef(name=nm, mu=mu) for nm, mu in names_mus]
        edges = [Edge(names_mus[i][0], names_mus[i + 1][0]) for i in range(len(names_mus) - 1)]
        return AppGraph(ops, edges, {names_mus[0][0]: lam0}, arrival_kind=arrival_kind)
