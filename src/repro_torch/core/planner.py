"""FleetPlanner -- cross-tenant Programs (4)/(6) on one shared pool, the
counterpart of ``repro/core/planner.py``.

M tenant graphs -- each its own Jackson network with its own arrival
process and optionally its own real-time constraint T_max -- share one
processor pool K_max:

    min   sum_m w_m * sum_i lam_{m,i} * E[T_{m,i}](k_{m,i})
    s.t.  sum_m sum_i k_{m,i} <= K_max,
          E[T_m](k_m) <= T_max_m             for tenants that declare one.

Each tenant's objective is separable and convex in its own k (paper
Ineq. 5), so the optimum is Algorithm 1's marginal-benefit greedy over the
*merged* gain tables: every tenant first gets its Program-(6) floor (its
T_max floor, or the stability floor without a T_max), then the rest of the
pool goes one processor at a time to the globally largest weighted gain
``w_m * lam_i * (E[T_i](k) - E[T_i](k+1))``.  :meth:`FleetPlanner.plan`
walks that greedy on the host (``allocator.greedy_increments``);
:meth:`FleetPlanner.plan_batched` makes it one top-R selection over the
stacked ``[sum_m N_m, budget]`` candidate tile (``kernels/gain_topr``: the
CUDA kernel on the card, its plain version on the CPU).

``objective="fair"`` (default) weights ``w_m = 1 / lam0_m`` (minimises
``sum_m E[T_m]``); ``objective="throughput"`` weights ``w_m = 1``
(Program (4) on the block-diagonal union of the tenants).
``Tenant.weight`` multiplies on top.

When the T_max floors alone exceed the pool, the plan is flagged
``overloaded`` and the whole pool is still handed out best-effort from the
stability minima (the caller, :class:`~repro_torch.api.session
.FleetSession`, leases at once).  Numpy float64 throughout, but for the
batched selection's ``device`` / ``dtype``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from .allocator import (
    AllocationResult,
    InsufficientResourcesError,
    candidate_window,
    greedy_increments,
    min_processors_table,
)
from .batched import gain_table
from .jackson import Topology

__all__ = ["Tenant", "FleetPlan", "FleetPlanner"]


@dataclass(frozen=True)
class Tenant:
    """One tenant: a declared graph (or a prebuilt / measured Topology), an
    optional real-time constraint, and an objective weight multiplier
    (> 0; default 1)."""

    name: str
    graph: object | None = None  # an AppGraph (untyped: core does not import api)
    topology: Topology | None = None
    t_max: float | None = None
    weight: float = 1.0

    def __post_init__(self) -> None:
        if self.graph is None and self.topology is None:
            raise ValueError(f"tenant {self.name!r}: need a graph or a topology")
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name!r}: weight must be > 0, got {self.weight}")

    def resolve(self, override: Topology | None = None) -> Topology:
        if override is not None:
            return override
        if self.topology is not None:
            return self.topology
        return self.graph.topology()


@dataclass(frozen=True)
class FleetPlan:
    """One cross-tenant allocation decision."""

    k: dict[str, np.ndarray]  # tenant -> per-operator allocation
    per_tenant: dict[str, AllocationResult]
    total: int  # processors handed out
    k_max: int  # pool size planned against
    needed_total: int  # sum of per-tenant Program-(6) floors
    overloaded: bool  # floors alone exceed the pool
    unmet: tuple[str, ...] = ()  # declared T_max not satisfied by this plan
    unreachable: tuple[str, ...] = ()  # T_max below the tenant's service floor
    objective: float = math.inf  # sum_m w_m * lam0_m * E[T_m]
    evaluations: int = 0  # table entries materialised

    def as_dict(self) -> dict:
        return {
            "k": {t: k.tolist() for t, k in self.k.items()},
            "expected_sojourn": {
                t: r.expected_sojourn for t, r in self.per_tenant.items()
            },
            "total": self.total,
            "k_max": self.k_max,
            "needed_total": self.needed_total,
            "overloaded": self.overloaded,
            "unmet": list(self.unmet),
            "unreachable": list(self.unreachable),
            "objective": self.objective,
        }


@dataclass
class FleetPlanner:
    """Solves the cross-tenant program on merged per-tenant gain tables."""

    tenants: list[Tenant]
    k_max: int
    objective: str = "fair"  # "fair" | "throughput"
    _names: list[str] = field(init=False, repr=False)

    def __post_init__(self) -> None:
        self.tenants = list(self.tenants)
        if not self.tenants:
            raise ValueError("fleet needs at least one tenant")
        self._names = [t.name for t in self.tenants]
        if len(set(self._names)) != len(self._names):
            dupes = sorted({n for n in self._names if self._names.count(n) > 1})
            raise ValueError(f"duplicate tenant names: {dupes}")
        if self.objective not in ("fair", "throughput"):
            raise ValueError(
                f"unknown objective {self.objective!r}; expected 'fair' or 'throughput'"
            )

    # ------------------------------------------------------------------ #
    def weight(self, tenant: Tenant, top: Topology) -> float:
        """Gain multiplier w_m under the fleet objective (the session's
        improvement gate scores with the same formula).  A zero-traffic
        tenant gets a guard, not a division by zero."""
        base = (
            1.0 / max(top.lam0_total, 1e-300) if self.objective == "fair" else 1.0
        )
        return tenant.weight * base

    def plan(
        self,
        topologies: dict[str, Topology] | None = None,
        *,
        k_max: int | None = None,
    ) -> FleetPlan:
        """Solve the fleet program on the host.  ``topologies`` overrides
        tenants' declared graphs with measured models.

        Raises :class:`InsufficientResourcesError` when even the stability
        minima do not fit the pool.
        """
        resolved, ctx = self._floors(topologies, k_max)
        take = np.zeros(sum(top.n for _, top in resolved), dtype=np.int64)
        if ctx["budget"] > 0:
            rows, k_start, evals = self._gain_rows(resolved, ctx["starts"], ctx["budget"])
            ctx["evals"] += evals
            take = greedy_increments(rows, k_start, ctx["budget"])
        return self._assemble(resolved, take, ctx)

    def plan_batched(
        self,
        topologies: dict[str, Topology] | None = None,
        *,
        k_max: int | None = None,
        mesh=None,
        device=None,
        dtype=None,
    ) -> FleetPlan:
        """:meth:`plan` with the merged greedy as one top-R selection
        (``kernels/gain_topr``) over the stacked tenant rows, on ``device``
        (default: the CUDA device, raising when there is none) in ``dtype``
        (default float32, the kernel's type).

        The floors and the gain tables are the same float64 numpy as
        :meth:`plan`'s, and ``gain_topr`` implements ``greedy_increments``'s
        threshold and row-major tie rule, so in float64 (the plain version,
        on the CPU) the plan equals the scalar one bit for bit; in float32
        the cast can resolve near-ties differently, as the reference's does
        without x64.  On the card the whole fleet is one scenario of the
        kernel: past 32 rows or 512 gains it takes the grid route, which
        spreads the tile over the whole card and holds any number of rows.

        ``mesh`` (a 1-D :class:`~repro_torch.distributed.FleetMesh`) runs the
        selection as the fleet reduction over its ranks: the rows are
        sharded, every rank gathers the whole table and selects over it,
        keeps its own rows' takes, and the takes are gathered back, so every
        rank returns the same plan, equal to the unsharded one.  ``device``
        defaults to the mesh's.
        """
        if mesh is not None:
            from ..distributed.sharding import mesh_axis

            mesh_axis(mesh, "fleet")
            if device is None:
                device = mesh.device
        dev = resolve_device(device)
        dtype = torch.float32 if dtype is None else dtype
        resolved, ctx = self._floors(topologies, k_max)
        take = np.zeros(sum(top.n for _, top in resolved), dtype=np.int64)
        if ctx["budget"] > 0:
            rows, k_start, evals = self._gain_rows(resolved, ctx["starts"], ctx["budget"])
            ctx["evals"] += evals
            take = _merged_topr(rows, k_start, ctx["budget"], mesh=mesh, device=dev,
                                dtype=dtype)
        return self._assemble(resolved, take, ctx)

    # ------------------------------------------------------------------ #
    # Shared plan stages (scalar and batched solvers)
    # ------------------------------------------------------------------ #
    def _floors(
        self, topologies: dict[str, Topology] | None, k_max: int | None
    ) -> tuple[list, dict]:
        """Resolve tenants, compute Program-(6) floors, classify overload,
        and derive the residual budget: everything before the greedy."""
        k_max = self.k_max if k_max is None else k_max
        tops = topologies or {}
        resolved = [(t, t.resolve(tops.get(t.name))) for t in self.tenants]
        k_min = [top.min_feasible_allocation() for _, top in resolved]
        min_total = int(sum(int(k.sum()) for k in k_min))
        if min_total > k_max:
            raise InsufficientResourcesError(
                min_total, k_max, np.concatenate(k_min)
            )
        evals = 0

        # Program (6) floors: what each tenant needs for its T_max.
        floors: list[np.ndarray] = []
        unreachable: list[str] = []
        for (tenant, top), km in zip(resolved, k_min):
            if tenant.t_max is None:
                floors.append(km.astype(np.int64))
                continue
            try:
                need = min_processors_table(top, tenant.t_max)
                evals += need.evaluations
                floors.append(need.k.astype(np.int64))
            except InsufficientResourcesError:
                unreachable.append(tenant.name)
                floors.append(km.astype(np.int64))
        needed_total = int(sum(int(f.sum()) for f in floors))

        # Overload: the floors do not fit the pool.
        overloaded = needed_total > k_max
        starts = k_min if overloaded else floors  # best effort vs floors granted
        granted = int(sum(int(s.sum()) for s in starts))
        return resolved, {
            "k_max": k_max,
            "needed_total": needed_total,
            "overloaded": overloaded,
            "unreachable": unreachable,
            "starts": starts,
            "budget": k_max - granted,
            "evals": evals,
        }

    def _gain_rows(
        self, resolved: list, starts: list, budget: int
    ) -> tuple[np.ndarray, np.ndarray, int]:
        """Stacked weighted gain rows ``[sum_m N_m, width]`` + start
        columns: the merged table both solvers select from."""
        evals = 0
        k_start = np.concatenate([s.astype(np.int64) for s in starts])
        width = int(max(int(s.max()) for s in starts)) + budget
        rows = []
        for (tenant, top), s in zip(resolved, starts):
            k_hi = int(s.max()) + budget
            T, G = gain_table(top, k_hi)
            evals += T.size
            w = self.weight(tenant, top)
            Gw = np.full((top.n, width), -np.inf)
            Gw[:, :k_hi] = w * G
            rows.append(Gw)
        return np.vstack(rows), k_start, evals

    def _assemble(self, resolved: list, take: np.ndarray, ctx: dict) -> FleetPlan:
        k_out: dict[str, np.ndarray] = {}
        per_tenant: dict[str, AllocationResult] = {}
        unmet: list[str] = []
        objective = 0.0
        off = 0
        for (tenant, top), s in zip(resolved, ctx["starts"]):
            n = top.n
            k = np.asarray(s, dtype=np.int64) + take[off : off + n]
            off += n
            et = top.expected_sojourn(k)
            k_out[tenant.name] = k
            per_tenant[tenant.name] = AllocationResult(k, et, int(k.sum()), 0)
            if tenant.t_max is not None and not et <= tenant.t_max:
                unmet.append(tenant.name)
            w = self.weight(tenant, top)
            objective += w * top.lam0_total * et if math.isfinite(et) else math.inf
        return FleetPlan(
            k=k_out,
            per_tenant=per_tenant,
            total=int(sum(int(k.sum()) for k in k_out.values())),
            k_max=ctx["k_max"],
            needed_total=ctx["needed_total"],
            overloaded=ctx["overloaded"],
            unmet=tuple(unmet),
            unreachable=tuple(ctx["unreachable"]),
            objective=objective,
            evaluations=ctx["evals"],
        )


def _merged_topr(G: np.ndarray, k_start: np.ndarray, budget: int, *, mesh=None, device,
                 dtype) -> np.ndarray:
    """``greedy_increments``'s selection as one ``gain_topr`` call over the
    merged fleet rows: the whole fleet's budget to the globally largest
    positive gains of the candidate window (finite: every start sits at or
    above its stability minimum), as a single scenario (``[1, R,
    budget]``).

    With ``mesh`` the rows are padded with zero-gain rows (never selected)
    to a multiple of the rank count and cut per rank; each rank
    ``all_gather``s the whole table, selects over it (the same selection on
    every rank), keeps its own rows' takes, and the takes are gathered
    back."""
    from ..kernels.gain_topr import ops as topr_ops

    r = G.shape[0]
    if budget <= 0:
        return np.zeros(r, dtype=np.int64)
    cand = torch.as_tensor(candidate_window(G, k_start, budget)).to(device=device, dtype=dtype)
    budget_t = torch.tensor([budget], dtype=torch.int32, device=device)
    if mesh is None:
        take = topr_ops.gain_topr(cand[None].contiguous(), budget_t)[0]
        return take.cpu().numpy().astype(np.int64)
    r_pad = -(-r // mesh.size) * mesh.size
    if r_pad > r:
        cand = torch.cat([cand, cand.new_zeros((r_pad - r, budget))])
    rows = mesh.shard(r_pad)
    merged = mesh.all_gather(cand[rows].contiguous())
    take_all = topr_ops.gain_topr(merged[None], budget_t)[0]
    take = mesh.all_gather(take_all[rows].contiguous())[:r]
    return take.cpu().numpy().astype(np.int64)
