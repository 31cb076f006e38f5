"""Sessions: one AppGraph bound to a backend, and the scenario runner.

* :class:`DRSSession` binds a graph to the :class:`DESBackend` (the
  discrete-event :class:`~repro_torch.streaming.des.NetworkSimulator`, in
  simulated time on the host; the default, as in the reference) or the
  :class:`EngineBackend` (the threaded
  :class:`~repro_torch.streaming.engine.StreamEngine`).  On the engine it
  owns the live measure -> model -> rebalance loop of
  ``repro.api.session.DRSSession``: it builds the
  :class:`~repro_torch.core.scheduler.DRSScheduler` from the graph, wires
  the engine's measurer to it, and applies each tick's decision to the
  running workers; ``DRSSession.bind(graph, "engine")`` runs the
  operators' kernels on the CUDA device unless given ``device="cpu"``.
* :class:`ScenarioRunner` sweeps a matrix of scenarios through the closed
  control loop: every ``tick_interval`` of simulated time the fleet
  advances one window.  Static-budget scenarios on ``backend="torch"`` run
  the fused loop (:func:`~repro_torch.core.controller.make_fused_loop`);
  otherwise the window-at-a-time loop runs
  :class:`~repro_torch.streaming.batchsim.BatchQueueSim` and the float64
  twin :func:`~repro_torch.core.controller.tick_batch`, with the
  negotiators' leases as hooks between windows.
* :class:`FleetSession` schedules several sessions against one shared pool:
  each tick stacks the tenants' measurements and solves the merged
  Programs (4)/(6) (:class:`~repro_torch.core.planner.FleetPlanner`; with
  ``solver="batched"`` one ``gain_topr`` launch on the card).

Typical live use::

    session = DRSSession.bind(graph, "engine", config=SchedulerConfig(k_max=6))
    session.start({"extract": 1, "match": 2, "aggregate": 1})
    ...inject tuples...
    session.tick()          # pulls measurements, decides, applies rescale
    session.drain(); session.stop()

    report = graph.bind("des", seed=3, horizon=2000.0).simulate(k)
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from ..core import controller as ctl
from ..core.allocator import AllocationResult, InsufficientResourcesError, allocate
from ..core.jackson import Topology
from ..core.measurer import MeasurementBatch, Measurer, stack_snapshots
from ..core.negotiator import Negotiator
from ..core.planner import FleetPlan, FleetPlanner, Tenant
from ..core.rebalance import ExecutableCache, RebalanceCostModel
from ..core.scheduler import DRSScheduler, SchedulerConfig, SchedulerDecision
from ..device import resolve_device
from .graph import AppGraph, GraphValidationError

__all__ = ["SchedulerConfig", "SchedulerDecision", "EngineBackend", "DESBackend",
           "DRSSession", "FleetDecision", "FleetSession", "ScenarioReport", "ScenarioRunner"]


def _group_effective_services(top: Topology, k_vec: np.ndarray):
    """Group-scaled operators for the DES: one fast server at ``mu * k *
    eff(k)`` instead of k parallel servers."""
    from ..streaming.des import ServiceProcess

    services, k_eff = [], []
    for i, op in enumerate(top.operators):
        k_i = int(k_vec[i])
        if op.scaling == "group":
            eff = 1.0 / (1.0 + op.group_alpha * (k_i - 1))
            services.append(ServiceProcess(rate=op.mu * k_i * eff))
            k_eff.append(1)
        else:
            services.append(ServiceProcess(rate=op.mu))
            k_eff.append(k_i)
    return services, np.asarray(k_eff, dtype=np.int64)


class EngineBackend:
    """The live :class:`~repro_torch.streaming.engine.StreamEngine` behind
    the session.

    ``device`` (default: the CUDA device, raising without one) is where the
    engine's workers launch: on a card each worker thread owns a CUDA
    stream and waits for it before it stops its service clock.  The
    operators' compute is the graph's ``fn``s, built for the same device
    (e.g. :func:`~repro_torch.streaming.apps.vld.build_vld_graph`).
    ``queue_capacity`` bounds every operator queue (``None`` = unbounded)
    and ``overload_policy`` (``"block"`` | ``"shed-newest"`` |
    ``"shed-oldest"``) decides what happens when one fills.
    """

    kind = "engine"

    def __init__(
        self,
        graph: AppGraph,
        *,
        device=None,
        queue_capacity: int | None = 10_000,
        overload_policy: Any = "block",
    ):
        from ..streaming.engine import Operator, StreamEngine

        missing = [op.name for op in graph.ops if op.fn is None]
        if missing:
            raise GraphValidationError(
                f"engine backend needs a compute fn on every operator; "
                f"missing: {missing} (attach with AppGraph.with_fns)"
            )
        self.graph = graph
        self.device = resolve_device(device)
        self.engine = StreamEngine(
            [Operator(op.name, op.fn) for op in graph.ops],
            queue_capacity=queue_capacity,
            overload_policy=overload_policy,
            device=self.device,
        )
        self.measurer: Measurer = self.engine.measurer

    def start(self, k: Mapping[str, int]) -> None:
        self.engine.start(dict(k))

    def apply_allocation(self, k: Mapping[str, int]) -> None:
        self.engine.scale_to(dict(k))

    def allocation(self) -> dict[str, int]:
        return self.engine.k()

    def inject(
        self, payload: Any, source: str | None = None, *, timeout: float | None = None
    ) -> int | None:
        if source is None:
            srcs = self.graph.source_names
            if len(srcs) != 1:
                raise GraphValidationError(
                    f"graph has {len(srcs)} sources {srcs}; pass source= explicitly"
                )
            source = srcs[0]
        return self.engine.inject(source, payload, timeout=timeout)

    def drain(self, timeout: float = 10.0) -> bool:
        return self.engine.drain(timeout=timeout)

    def stop(self) -> None:
        self.engine.stop()

    @property
    def completed_sojourns(self) -> list[float]:
        return self.engine.completed_sojourns

    def drop_counts(self) -> dict[str, int]:
        """Cumulative tuples shed per operator (overload policy drops)."""
        return self.engine.drop_counts()


class DESBackend:
    """The discrete-event :class:`~repro_torch.streaming.des.NetworkSimulator`
    behind the session (simulated time; host code, no device).
    ``arrival_kw`` holds extra ``ArrivalProcess`` parameters for every
    source (``rate2`` etc. for the ``mmpp`` and ``burst`` kinds)."""

    kind = "des"

    def __init__(
        self,
        graph: AppGraph,
        *,
        seed: int = 0,
        horizon: float = 120.0,
        warmup: float = 10.0,
        network_delay: float = 0.0,
        arrival_kind: str | None = None,
        arrival_kw: Mapping[str, float] | None = None,
        measurer: Measurer | None = None,
        queue_capacity: int | None = None,
        overload_policy: Any = "shed-newest",
    ):
        self.graph = graph
        self.seed = seed
        self.horizon = horizon
        self.warmup = warmup
        self.network_delay = network_delay
        self.arrival_kind = arrival_kind or graph.arrival_kind
        self.arrival_kw = dict(arrival_kw or {})
        self.measurer = measurer
        self.queue_capacity = queue_capacity
        self.overload_policy = overload_policy

    # The DES is batch-simulated, not tick-driven: the live protocol fails
    # with a pointer to simulate().
    def _not_live(self, method: str):
        raise GraphValidationError(
            f"DES backend is batch-simulated; {method}() is only available on "
            "the engine backend -- use simulate(k, rebalance_to=, rebalance_at=) "
            "to run allocation changes in simulated time"
        )

    def start(self, k):
        self._not_live("start")

    def apply_allocation(self, k):
        self._not_live("apply_allocation")

    def allocation(self):
        self._not_live("allocation")

    def inject(self, payload, source=None):
        self._not_live("inject")

    def drain(self, timeout: float = 10.0):
        self._not_live("drain")

    def stop(self):
        self._not_live("stop")

    @property
    def completed_sojourns(self):
        self._not_live("completed_sojourns")

    def simulator(self, k: Mapping[str, int] | Sequence[int] | np.ndarray, *,
                  seed: int | None = None, horizon: float | None = None,
                  warmup: float | None = None):
        """A NetworkSimulator for allocation ``k`` (group operators
        collapsed to single effective servers, each operator's declared
        service law applied at that rate)."""
        from ..streaming.des import ArrivalProcess, NetworkSimulator, ServiceProcess, SimConfig

        graph = self.graph
        top = graph.topology()
        services, k_eff = _group_effective_services(top, graph.k_vector(k))
        for i, op in enumerate(graph.ops):
            if op.service_kind != "exponential" or op.service_cv != 1.0:
                services[i] = ServiceProcess(rate=services[i].rate, kind=op.service_kind,
                                             cv=op.service_cv)
        arrivals = [
            ArrivalProcess(rate=float(top.lam0[i]), kind=self.arrival_kind, **self.arrival_kw)
            for i in range(top.n)
        ]
        cfg = SimConfig(
            seed=self.seed if seed is None else seed,
            horizon=self.horizon if horizon is None else horizon,
            warmup=self.warmup if warmup is None else warmup,
            network_delay=self.network_delay,
            queue_capacity=self.queue_capacity,
            overload_policy=self.overload_policy,
        )
        return NetworkSimulator(top, k_eff, config=cfg, arrivals=arrivals,
                                services=services, measurer=self.measurer)

    def simulate(self, k, *, rebalance_to=None, rebalance_at: float | None = None,
                 pause: float = 1.0, seed: int | None = None, horizon: float | None = None,
                 warmup: float | None = None):
        """Run the DES under ``k``; optionally switch to ``rebalance_to`` at
        ``rebalance_at`` (with a processing pause) mid-run."""
        sim = self.simulator(k, seed=seed, horizon=horizon, warmup=warmup)
        if rebalance_to is not None and rebalance_at is not None:
            top = sim.top
            services2, k2_eff = _group_effective_services(top, self.graph.k_vector(rebalance_to))
            for i, op in enumerate(top.operators):
                if op.scaling == "group":
                    sim.schedule_rate_change(rebalance_at, i, services2[i].rate)
            sim.rebalance_at(rebalance_at, k2_eff, pause=pause)
        return sim.run()


_BACKENDS = {"engine": EngineBackend, "des": DESBackend}


class DRSSession:
    """One AppGraph + one backend + the DRS control loop.

    Construction wires the scheduler from the graph (names, routing
    matrix, scaling modes) and the backend's measurer.  On the engine
    ``tick()`` pulls, models, decides, and *applies* the decision; on the
    DES :meth:`simulate` runs an allocation in simulated time.
    ``proactive`` (True or an :class:`~repro_torch.forecast.mpc.MPCConfig`)
    gives the scheduler the forecast/MPC plane; a ``"proactive"`` decision
    is applied like a rebalance.
    """

    def __init__(
        self,
        graph: AppGraph,
        backend: EngineBackend | DESBackend,
        *,
        config: SchedulerConfig | None = None,
        negotiator: Negotiator | None = None,
        cost_model: RebalanceCostModel | None = None,
        executable_cache: ExecutableCache | None = None,
        on_decision=None,
        proactive=None,
    ):
        self.graph = graph
        self.backend = backend
        self.config = config or SchedulerConfig()
        self.negotiator = negotiator
        self.cost_model = cost_model
        self.executable_cache = executable_cache
        self.on_decision = on_decision
        self.proactive = proactive  # forecast/MPC mode (MPCConfig | True)
        self.scheduler: DRSScheduler | None = None

    @classmethod
    def bind(cls, graph: AppGraph, backend: Any = "des", **kwargs) -> "DRSSession":
        """Bind ``graph`` to ``backend``: ``"des"`` (the default, as in the
        reference), ``"engine"``, or a built backend.  Session options
        (``config=``, ``negotiator=``, ``cost_model=``,
        ``executable_cache=``, ``on_decision=``, ``proactive=``) are taken
        from ``kwargs``; the rest go to the backend (the engine's
        ``device=``, ``queue_capacity=``, ``overload_policy=``; the DES's
        ``seed=``, ``horizon=``, ``warmup=``, ...)."""
        session_keys = ("config", "negotiator", "cost_model", "executable_cache",
                        "on_decision", "proactive")
        session_kw = {k: kwargs.pop(k) for k in session_keys if k in kwargs}
        if isinstance(backend, str):
            try:
                backend_cls = _BACKENDS[backend]
            except KeyError:
                raise GraphValidationError(
                    f"unknown backend {backend!r}; expected one of {sorted(_BACKENDS)} "
                    "or a backend instance"
                ) from None
            backend = backend_cls(graph, **kwargs)
        elif kwargs:
            raise GraphValidationError(
                f"unexpected options for pre-built backend: {sorted(kwargs)}"
            )
        return cls(graph, backend, **session_kw)

    # Model side --------------------------------------------------------- #
    def topology(self, mu: Mapping[str, float] | None = None) -> Topology:
        return self.graph.topology(mu)

    def plan(self, *, k_max: int | None = None, t_max: float | None = None
             ) -> AllocationResult:
        """Program (4)/(6) on the declared graph (priors, not measurements)."""
        k_max = k_max if k_max is not None else self.config.k_max
        t_max = t_max if t_max is not None else self.config.t_max
        if k_max is None and t_max is None:
            raise GraphValidationError(
                "plan() needs a budget: pass k_max= or t_max=, or bind with "
                "config=SchedulerConfig(k_max=..., t_max=...)"
            )
        return allocate(self.topology(), k_max=k_max, t_max=t_max)

    # Control loop ------------------------------------------------------- #
    def _build_scheduler(self, k0: np.ndarray) -> DRSScheduler:
        scaling, group_alpha = self.graph.scaling_lists()
        return DRSScheduler(
            self.graph.names,
            self.graph.routing_matrix(),
            k0,
            self.config,
            measurer=self.backend.measurer,
            negotiator=self.negotiator,
            cost_model=self.cost_model,
            executable_cache=self.executable_cache,
            scaling=scaling,
            group_alpha=group_alpha,
            on_decision=self.on_decision,
            proactive=self.proactive,
        )

    def start(self, k0: Mapping[str, int] | Sequence[int] | np.ndarray | None = None
              ) -> dict[str, int]:
        """Start the backend under ``k0`` (default: the planned optimum)
        and arm the scheduler.  Returns the starting allocation."""
        k0_vec = self.plan().k if k0 is None else self.graph.k_vector(k0)
        self.scheduler = self._build_scheduler(k0_vec.copy())
        self.backend.start(self.graph.k_dict(k0_vec))
        # Anchor the measurer's pull clock so the first tick has a window.
        self.backend.measurer.pull(time.time())
        return self.graph.k_dict(k0_vec)

    def tick(self, now: float | None = None) -> SchedulerDecision:
        """One scheduler tick: pull -> model -> decide -> apply."""
        if self.scheduler is None:
            raise RuntimeError("session not started; call start() first")
        decision = self.scheduler.tick(now)
        if decision.action in ("rebalance", "scale_out", "scale_in", "overloaded",
                               "proactive"):
            # "overloaded" with no feasible target keeps the current k.
            if decision.k_target is not None:
                self.backend.apply_allocation(self.graph.k_dict(decision.k_target))
        return decision

    @property
    def allocation(self) -> dict[str, int]:
        if self.scheduler is not None:
            return self.graph.k_dict(self.scheduler.k_current)
        return self.backend.allocation()

    @property
    def history(self) -> list[SchedulerDecision]:
        return [] if self.scheduler is None else self.scheduler.history

    # Backend pass-throughs ---------------------------------------------- #
    def inject(self, payload: Any, source: str | None = None, *,
               timeout: float | None = None) -> int | None:
        """Inject an external tuple.  Under a bounded queue with the
        ``block`` policy this backpressures the caller; returns ``None``
        when the tuple was shed at admission."""
        if isinstance(self.backend, EngineBackend):
            return self.backend.inject(payload, source=source, timeout=timeout)
        return self.backend.inject(payload, source=source)

    def drain(self, timeout: float = 10.0) -> bool:
        return self.backend.drain(timeout=timeout)

    def stop(self) -> None:
        self.backend.stop()

    @property
    def completed_sojourns(self) -> list[float]:
        return self.backend.completed_sojourns

    def drop_counts(self) -> dict[str, int]:
        """Cumulative tuples shed per operator (engine backend)."""
        if not isinstance(self.backend, EngineBackend):
            raise GraphValidationError(
                "drop_counts() needs the engine backend; the DES reports "
                "drops on its SimResult (per_op_dropped / per_op_drop_rate)"
            )
        return self.backend.drop_counts()

    def simulate(self, k=None, **kwargs):
        """DES mode: simulate allocation ``k`` (default: the planned optimum)."""
        if not isinstance(self.backend, DESBackend):
            raise GraphValidationError(
                f"simulate() needs a DES backend, have {self.backend.kind!r}"
            )
        if k is None:
            k = self.plan().k
        return self.backend.simulate(k, **kwargs)

    def run(self, k=None, **kwargs):
        """One-call entry point: DES -> :meth:`simulate`; engine ->
        :meth:`start` (then inject / tick / drain at your own pace)."""
        if isinstance(self.backend, DESBackend):
            return self.simulate(k, **kwargs)
        return self.start(k)


# --------------------------------------------------------------------------- #
# Fleet: several sessions against one shared pool
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class FleetDecision:
    """One fleet control tick's outcome."""

    t: float
    # "none" | "rebalance" | "scale_in" | "overloaded" | "infeasible"
    action: str
    k_max: int
    plan: FleetPlan | None
    # tenant -> name-keyed allocation in force after the tick
    k: dict
    overloaded_tenants: tuple = ()
    objective_current: float = float("inf")
    reason: str = ""


class FleetSession:
    """Several :class:`DRSSession` tenants scheduled against ONE pool.

    Every tick pulls each tenant's measurements, rebuilds each tenant's
    model (with the scheduler's offered-load clamp where a tenant is
    overloaded), and solves the merged Programs (4)/(6) with
    :class:`~repro_torch.core.planner.FleetPlanner`; each tenant's ``T_max``
    is its session's ``SchedulerConfig.t_max``.

    Any tenant measuring ``rho >= 1``, or Program-(6) floors past the pool,
    makes the tick ``"overloaded"``: the negotiator is asked for capacity at
    once and the replan is applied with no improvement gate.  Model-only
    tenants (never started: DES-bound sessions) feed the planner their
    declared priors; their allocations are tracked, not applied.

    ``solver="scalar"`` (the default, as in the reference) walks the merged
    greedy on the host; ``solver="batched"`` selects it in one ``gain_topr``
    launch (:meth:`FleetPlanner.plan_batched`) on ``device`` (default: the
    CUDA device, raising when there is none) in ``dtype`` (default
    float32); ``mesh=`` (a 1-D :class:`~repro_torch.distributed.FleetMesh`,
    ``solver="batched"`` only) runs that selection as the fleet reduction
    over the mesh's ranks (:meth:`FleetPlanner.plan_batched`), on the
    mesh's device unless ``device`` says otherwise.

    Typical use::

        fleet = FleetSession(
            {"vld": vld_graph.bind("engine", config=SchedulerConfig(t_max=0.5)),
             "fpd": fpd_graph.bind("engine", config=SchedulerConfig(t_max=2.0))},
            k_max=64, solver="batched",
        )
        fleet.start()          # plans the pool split and starts each backend
        ...inject per tenant...
        fleet.tick()           # merged measure -> model -> replan -> apply
    """

    def __init__(
        self,
        sessions: Mapping[str, DRSSession],
        *,
        k_max: int | None = None,
        negotiator: Negotiator | None = None,
        objective: str = "fair",
        min_improvement: float = 0.05,
        headroom: float = 1.1,
        scale_in_hysteresis: float = 0.8,
        on_decision=None,
        solver: str = "scalar",
        mesh=None,
        device=None,
        dtype=None,
    ):
        if not sessions:
            raise GraphValidationError("fleet needs at least one session")
        if k_max is None and negotiator is None:
            raise GraphValidationError("fleet needs k_max= and/or negotiator=")
        if solver not in ("scalar", "batched"):
            raise GraphValidationError(
                f"unknown solver {solver!r}; expected 'scalar' or 'batched'"
            )
        if mesh is not None and solver != "batched":
            raise GraphValidationError("mesh= requires solver='batched'")
        self.sessions: dict[str, DRSSession] = dict(sessions)
        self._static_k_max = k_max
        self.negotiator = negotiator
        self.objective = objective
        self.min_improvement = min_improvement
        self.headroom = headroom
        self.scale_in_hysteresis = scale_in_hysteresis
        self.on_decision = on_decision
        self.solver = solver
        self.mesh = mesh
        if device is None and mesh is not None:
            device = mesh.device
        self.device = resolve_device(device) if solver == "batched" else None
        self.dtype = torch.float32 if dtype is None else dtype
        self.history: list[FleetDecision] = []
        # tenant -> index-ordered allocation in force
        self._k: dict[str, np.ndarray] = {}

    # ------------------------------------------------------------------ #
    @property
    def k_max(self) -> int:
        if self.negotiator is not None:
            k = self.negotiator.k_max
            return max(k, self._static_k_max or 0)
        return self._static_k_max

    def tenants(self) -> list[Tenant]:
        return [
            Tenant(name=name, graph=s.graph, t_max=s.config.t_max)
            for name, s in self.sessions.items()
        ]

    def planner(self) -> FleetPlanner:
        return FleetPlanner(self.tenants(), self.k_max, objective=self.objective)

    def plan(self, *, k_max: int | None = None) -> FleetPlan:
        """Cross-tenant Programs (4)/(6) on the declared priors."""
        return self._plan_with(self.planner(), k_max=k_max)

    def _plan_with(self, planner: FleetPlanner, tops: dict | None = None, *,
                   k_max: int | None = None) -> FleetPlan:
        """Every plan goes through here, so the solver choice applies to
        start and tick alike."""
        if self.solver == "batched":
            return planner.plan_batched(tops, k_max=k_max, mesh=self.mesh,
                                        device=self.device, dtype=self.dtype)
        return planner.plan(tops, k_max=k_max)

    def allocations(self) -> dict[str, dict[str, int]]:
        """tenant -> name-keyed allocation in force."""
        return {
            name: self.sessions[name].graph.k_dict(k) for name, k in self._k.items()
        }

    # ------------------------------------------------------------------ #
    def start(self) -> dict[str, dict[str, int]]:
        """Plan the pool split on priors and start every engine-backed
        tenant under its share (model-only tenants are planned, not
        started).  With a negotiator the first lease is taken here:
        stability minima first, then the Program-(6) floors."""
        try:
            plan = self.plan()
        except InsufficientResourcesError as e:
            if self.negotiator is None:
                raise
            self.negotiator.ensure(int(np.ceil(e.needed * self.headroom)))
            plan = self.plan()
        if self.negotiator is not None and plan.needed_total > self.k_max:
            self.negotiator.ensure(int(np.ceil(plan.needed_total * self.headroom)))
            plan = self.plan()
        for name, session in self.sessions.items():
            k = plan.k[name]
            self._k[name] = k.copy()
            if isinstance(session.backend, EngineBackend):
                session.start(k)
            else:
                # Arm the model side so tick() can track without a backend.
                session.scheduler = session._build_scheduler(k.copy())
        return self.allocations()

    def stop(self) -> None:
        for session in self.sessions.values():
            if isinstance(session.backend, EngineBackend):
                session.stop()

    # ------------------------------------------------------------------ #
    def _measured_topologies(self, now: float) -> tuple[dict, list[str]]:
        """Per-tenant measured model rebuilds and the overloaded tenants.

        The measurer pulls stay per tenant (live probes); the snapshots are
        stacked into one :class:`~repro_torch.core.measurer.MeasurementBatch`
        and the overload trigger and capped propagation run over the whole
        fleet at once before the per-tenant offered-load clamp.  Tenants
        without a complete snapshot (or never started) keep their declared
        priors (the planner resolves those from the graph)."""
        tops: dict[str, Topology] = {}
        hot: list[str] = []
        pulled: list[tuple[str, DRSScheduler]] = []
        snaps = []
        for name, session in self.sessions.items():
            sched = session.scheduler
            if sched is None:
                continue
            snap = sched.measurer.pull(now)
            sched._observe_instances()
            if not snap.complete():
                continue
            pulled.append((name, sched))
            snaps.append(snap)
        if not pulled:
            return tops, hot
        batch = stack_snapshots(snaps)
        b, n = batch.lam_hat.shape
        routing = np.zeros((b, n, n))
        group = np.zeros((b, n), dtype=bool)
        alpha = np.zeros((b, n))
        active = np.zeros((b, n), dtype=bool)
        k_cur = np.zeros((b, n), dtype=np.int64)
        mu_eff = batch.mu_hat.copy()
        for bi, (_, sched) in enumerate(pulled):
            ni = len(sched.names)
            routing[bi, :ni, :ni] = sched.base_routing
            group[bi, :ni] = sched._group
            alpha[bi, :ni] = sched._alpha
            active[bi, :ni] = True
            k_cur[bi, :ni] = sched.k_current
            if sched.speed_factors is not None:
                mu_eff[bi, :ni] = mu_eff[bi, :ni] * sched.speed_factors
        over = ctl.overloaded_mask_batch(
            batch.lam_hat, mu_eff, batch.drop_hat, k_cur, group, alpha
        ) & active
        capped = ctl.capped_mask_batch(over, routing, active)
        for bi, (name, sched) in enumerate(pulled):
            ni = len(sched.names)
            mask = over[bi, :ni]
            if mask.any():
                hot.append(name)
            tops[name] = ctl.clamp_row(
                sched.names,
                sched.base_routing,
                batch.lam_hat[bi, :ni],
                batch.mu_hat[bi, :ni],
                float(batch.lam0_hat[bi]),
                mask,
                capped[bi, :ni],
                sched.scaling,
                sched.group_alpha,
                speed=sched.speed_factors,
            )
        return tops, hot

    def _objective_of(self, planner: FleetPlanner, tops: dict) -> float:
        """Fleet objective of the allocations in force, weighted as the
        planner weights, so the improvement gate compares like with like."""
        if not self._k:
            return float("inf")
        total = 0.0
        for tenant in planner.tenants:
            k = self._k.get(tenant.name)
            if k is None:
                return float("inf")
            top = tenant.resolve(tops.get(tenant.name))
            et = top.expected_sojourn(k)
            w = planner.weight(tenant, top)
            total += w * top.lam0_total * et if np.isfinite(et) else float("inf")
        return total

    def _apply(self, plan: FleetPlan) -> dict:
        for name, session in self.sessions.items():
            k = plan.k[name]
            self._k[name] = k.copy()
            if session.scheduler is not None:
                session.scheduler.k_current = k.copy()
            if isinstance(session.backend, EngineBackend):
                session.backend.apply_allocation(session.graph.k_dict(k))
        return self.allocations()

    def tick(self, now: float | None = None) -> FleetDecision:
        """One fleet tick: pull every tenant, replan the pool, apply.

        The gates are ``DRSScheduler.decide``'s at fleet level: an
        improvement below ``min_improvement`` keeps the current split;
        overload (a tenant's measured rho >= 1, or floors past the pool)
        skips the gate and leases at once."""
        now = time.time() if now is None else now
        tops, hot = self._measured_topologies(now)
        k_max = self.k_max
        planner = FleetPlanner(self.tenants(), k_max, objective=self.objective)
        try:
            plan = self._plan_with(planner, tops, k_max=k_max)
        except InsufficientResourcesError as e:
            if self.negotiator is None:
                return self._emit(FleetDecision(
                    now, "infeasible", k_max, None, self.allocations(), tuple(hot),
                    reason=str(e),
                ))
            self.negotiator.ensure(int(np.ceil(e.needed * self.headroom)))
            k_max = self.k_max
            try:
                plan = self._plan_with(planner, tops, k_max=k_max)
            except InsufficientResourcesError as e2:
                return self._emit(FleetDecision(
                    now, "infeasible", k_max, None, self.allocations(), tuple(hot),
                    reason=str(e2),
                ))

        overloaded = bool(hot) or plan.overloaded
        if overloaded and self.negotiator is not None and plan.needed_total > k_max:
            # Overload: lease now, no hysteresis, no gate.
            self.negotiator.ensure(int(np.ceil(plan.needed_total * self.headroom)))
            if self.k_max > k_max:
                k_max = self.k_max
                plan = self._plan_with(planner, tops, k_max=k_max)
        elif (
            self.negotiator is not None
            and self._static_k_max is None
            # Scale in only when every tenant declares a T_max: otherwise the
            # "need" is the stability minimum, not a latency target.
            and all(t.t_max is not None for t in planner.tenants)
            and plan.needed_total > 0
            and np.ceil(plan.needed_total * self.headroom)
            < self.scale_in_hysteresis * k_max
        ):
            # Shrink the lease and the allocation together: replan at the
            # smaller pool and apply in the same tick, so the machines handed
            # back are never still part of the split in force.
            target = int(np.ceil(plan.needed_total * self.headroom))
            self.negotiator.ensure(target)
            if self.k_max < k_max:
                cur_obj = self._objective_of(planner, tops)
                k_max = self.k_max
                plan = self._plan_with(planner, tops, k_max=k_max)
                self._apply(plan)
                return self._emit(FleetDecision(
                    now, "scale_in", k_max, plan, self.allocations(), tuple(hot),
                    cur_obj,
                    reason=f"floors need {plan.needed_total} (headroom {target}) "
                    f"<< leased; released to k_max={k_max}",
                ))

        cur_obj = self._objective_of(planner, tops)
        if overloaded:
            self._apply(plan)
            return self._emit(FleetDecision(
                now, "overloaded", k_max, plan, self.allocations(), tuple(hot),
                cur_obj,
                reason=f"overloaded tenants {hot}; floors need "
                f"{plan.needed_total} of {k_max}",
            ))
        improvement = (
            (cur_obj - plan.objective) / cur_obj
            if np.isfinite(cur_obj) and cur_obj > 0
            else float("inf")
        )
        unchanged = all(
            np.array_equal(self._k.get(n), plan.k[n]) for n in self.sessions
        )
        if unchanged or improvement < self.min_improvement:
            return self._emit(FleetDecision(
                now, "none", k_max, plan, self.allocations(), tuple(hot), cur_obj,
                reason=f"improvement {improvement:.1%} < {self.min_improvement:.0%}",
            ))
        self._apply(plan)
        return self._emit(FleetDecision(
            now, "rebalance", k_max, plan, self.allocations(), tuple(hot), cur_obj,
            reason=f"fleet objective {cur_obj:.4g} -> {plan.objective:.4g}",
        ))

    def _emit(self, d: FleetDecision) -> FleetDecision:
        self.history.append(d)
        if self.on_decision:
            self.on_decision(d)
        return d


@dataclass(frozen=True)
class ScenarioReport:
    """One scenario's outcome after a controlled sweep."""

    name: str
    actions: tuple  # action per tick, in order
    allocations: tuple  # name-keyed allocation in force after each tick
    k_final: dict
    provisioned_total: int  # sum of the final allocation
    optimal_total: int | None  # Program (4)/(6) total at the mean true topology
    deadline_miss_rate: float  # post-warmup windows with measured E[T] > t_max
    drop_rate: float  # post-warmup shed fraction of offered load
    mean_sojourn: float  # visit-sum E[T] estimate at k_final
    saturated: tuple  # operator names at/above capacity post-warmup
    trajectory: dict | None = None  # per-tick t / k_total / miss / sojourn / warm


class ScenarioRunner:
    """Sweep a scenario matrix through the closed control loop.

    ``backend="torch"`` (the default) runs on ``device`` (default: the CUDA
    device, raising when there is none) in ``dtype`` (default float32, the
    kernels' type); ``backend="numpy"`` is the reference's float64 twin on
    the host.  The gate is the reference's: with ``fused=None`` the fused
    loop (:func:`~repro_torch.core.controller.make_fused_loop`) runs when
    ``controlled``, ``backend="torch"``, no scenario is ``negotiated`` and
    the horizon is a whole number of ticks; otherwise the window-at-a-time
    loop runs: each tick :class:`~repro_torch.streaming.batchsim
    .BatchQueueSim` advances one window (on the torch backend one
    ``queue_window`` launch), the window becomes one
    :class:`~repro_torch.core.measurer.MeasurementBatch` on the host, and
    :func:`~repro_torch.core.controller.tick_batch` decides in float64,
    the negotiators' leases as hooks between windows.  ``fused=True``
    past the gate raises :class:`GraphValidationError`.
    ``controlled=False`` freezes ``k`` (a pure simulation sweep).  A
    scenario object repeated in ``scenarios`` is planned and sampled once
    (fleets may tile a few distinct scenarios).

    ``proactive`` (True for the default
    :class:`~repro_torch.forecast.mpc.MPCConfig`, or one) switches on the
    forecast/MPC plane on either loop; trajectories gain ``mpc_used`` /
    ``confident``.  ``compact`` (True or a
    :class:`~repro_torch.core.controller.CompactionConfig`) runs the sparse
    decide: the fused loop's memo, or the twin's
    :class:`~repro_torch.core.controller.TwinCompactionState`; the outputs
    are the same either way.  ``mesh`` (a 1-D
    :class:`~repro_torch.distributed.FleetMesh`) shards the fused loop's
    batch axis over its ranks (every rank builds the same runner and gets
    the whole fleet's reports); it needs the fused loop, and ``device``
    defaults to the mesh's.
    """

    def __init__(self, scenarios: Sequence, *, tick_interval: float = 10.0,
                 controlled: bool = True, backend: str = "torch", fused: bool | None = None,
                 fused_decide: bool = False, proactive=None, compact=None, mesh=None,
                 device=None, dtype=None):
        from ..streaming.batchsim import BatchQueueSim
        from ..streaming.scenarios import pack_allocations, pack_scenarios

        if backend not in BatchQueueSim.BACKENDS:
            raise ValueError(
                f"unknown backend {backend!r}; expected one of {BatchQueueSim.BACKENDS}")
        self.backend = backend
        if device is None and mesh is not None:
            device = mesh.device
        self.device = resolve_device(device) if backend == "torch" else None
        self.mesh = mesh
        self.dtype = torch.float32 if dtype is None else dtype
        self.scenarios = list(scenarios)
        self.tick_interval = tick_interval
        self.controlled = controlled
        self.fused_decide = bool(fused_decide)
        self.compact = compact or None
        if proactive is True:
            from ..forecast.mpc import MPCConfig

            proactive = MPCConfig()
        self.proactive_cfg = proactive
        self.arrays = pack_scenarios(self.scenarios)
        self._steps_per_tick = max(int(round(tick_interval / self.arrays.dt)), 1)
        plans: dict[int, np.ndarray] = {}
        for s in self.scenarios:
            if id(s) not in plans:
                plans[id(s)] = s.plan_k0()
        self.k = pack_allocations(self.scenarios, [plans[id(s)] for s in self.scenarios])
        self.k0 = self.k.copy()  # the planned starting allocation
        self.static = ctl.ControllerStatic.from_graphs(
            [s.graph for s in self.scenarios],
            speed=[s.speed_vector() for s in self.scenarios],
        )
        self.negotiators = [self._negotiator_for(s, self.k[bi, : s.graph.n])
                            for bi, s in enumerate(self.scenarios)]
        can_fuse = (
            controlled
            and backend == "torch"
            and all(neg is None for neg in self.negotiators)
            and self.arrays.steps % self._steps_per_tick == 0
        )
        if fused is None:
            fused = can_fuse
        elif fused and not can_fuse:
            raise GraphValidationError(
                "fused=True requires controlled=True, backend='torch', no "
                "negotiated scenarios, and a horizon divisible by the tick "
                "interval; use fused=None for the automatic gate; negotiated "
                f"scenarios: {[s.name for s in self.scenarios if s.negotiated]}"
            )
        self.fused = bool(fused)
        if mesh is not None and not self.fused:
            raise GraphValidationError(
                "mesh= shards the fused loop's batch axis; it has no effect "
                "on the window-at-a-time path (pass fused=True or drop mesh)"
            )
        self.sim = None if self.fused else BatchQueueSim(
            self.arrays, backend=backend, device=self.device, dtype=self.dtype)
        # Per-scenario decision parameters; negotiator leases move the
        # budgets between ticks (_params()).
        self.params = ctl.ControllerParams.stack(
            [
                SchedulerConfig(k_max=None if neg is not None else s.k_max, t_max=s.t_max,
                                tick_interval=tick_interval, allocator=s.allocator,
                                fused_decide=self.fused_decide)
                for s, neg in zip(self.scenarios, self.negotiators)
            ],
            [neg.k_max if neg is not None else s.k_max
             for s, neg in zip(self.scenarios, self.negotiators)],
        )
        self.decisions: list[list[SchedulerDecision]] = [[] for _ in self.scenarios]
        self._miss = np.zeros(len(self.scenarios), dtype=np.int64)
        self._windows_warm = 0
        self._result = None
        self.loop_seconds = float("nan")  # wall time of the last loop run
        self._traj = [
            {"t": [], "k_total": [], "miss": [], "sojourn": [], "warm": []}
            for _ in self.scenarios
        ]

    def _negotiator_for(self, s, k0: np.ndarray):
        """A ``negotiated`` scenario's machine lease: ``machine_size``-
        processor machines (speed-tagged when the scenario declares
        machine-class factors) from a pool of ``k_max`` processors."""
        if not s.negotiated:
            return None
        from ..core.negotiator import Machine, ResourcePool

        size = max(int(s.machine_size), 1)
        speed = s.speed_vector()
        mean_speed = 1.0 if speed is None else float(np.mean(speed))
        pool = ResourcePool([Machine(f"m{i}", size, speed=mean_speed)
                             for i in range(-(-s.k_max // size))])
        negotiator = Negotiator(pool)
        negotiator.ensure(int(k0.sum()))
        return negotiator

    def _params(self) -> ctl.ControllerParams:
        """The decision parameters with each budget re-read from its
        negotiator's current lease."""
        if all(neg is None for neg in self.negotiators):
            return self.params
        return replace(self.params, k_max=np.array(
            [neg.k_max if neg is not None else s.k_max
             for s, neg in zip(self.scenarios, self.negotiators)],
            dtype=np.int64,
        ))

    def _window_measurement(self, w: dict) -> tuple[MeasurementBatch, np.ndarray]:
        """One stacked synthetic measurement from a window's aggregates, in
        float64 on the host.  The sojourn is NaN for a scenario that
        admitted no external tuples this window; ``mu_hat`` carries the
        reference-class priors (the controller applies the speed
        factors)."""
        from ..streaming.batchsim import (composed_wait_host, per_op_service_time,
                                          visit_sum_sojourn)

        a = self.arrays
        span = w["span"]
        lam_hat = w["offered"] / span
        drop_hat = w["dropped"] / span
        mu_eff = a.mu if a.speed is None else a.mu * a.speed
        admitted = np.maximum(lam_hat - drop_hat, 0.0)
        wait = composed_wait_host(w["q_mean"], admitted, a.dt, span, self.k, a.mu, a.group,
                                  a.alpha, a.speed, a.ca2, a.cs2)
        svc = per_op_service_time(w["capacity"], mu_eff, a.group)
        lam0 = np.maximum(w["ext_admitted"] / span, 0.0)
        sojourn = visit_sum_sojourn(admitted, wait, svc, lam0)
        return MeasurementBatch.from_rates(
            lam_hat, a.mu, lam0, sojourn, self.sim.now, drop_hat=drop_hat
        ), sojourn

    def _ensure_hooks(self):
        hooks = []
        for neg in self.negotiators:
            if neg is None:
                hooks.append(None)
            else:
                def hook(target: int, _neg=neg) -> int:
                    _neg.ensure(target)
                    return _neg.k_max
                hooks.append(hook)
        return hooks

    def _to_decision(self, bi: int, row: ctl.RowDecision, meas, error) -> SchedulerDecision:
        s = self.scenarios[bi]
        return SchedulerDecision(
            self.sim.now, row.action, row.k_next.copy(), row.k_target,
            s.k_max if error is not None else row.k_max, row.et_cur, row.et_target,
            float(meas.sojourn_hat[bi]), row.plan, row.reason,
        )

    def run(self) -> list[ScenarioReport]:
        if self.fused:
            return self._run_fused()
        a = self.arrays
        t_max = np.array([np.nan if s.t_max is None else s.t_max for s in self.scenarios])
        hooks = self._ensure_hooks()
        cstate = pc = None
        if self.controlled and self.compact is not None:
            cstate = ctl.TwinCompactionState.create(len(self.scenarios), self.static.n)
        if self.controlled and self.proactive_cfg is not None:
            from ..forecast.mpc import ProactiveController

            pc = ProactiveController.create(
                len(self.scenarios), self.static.n, self.proactive_cfg,
                cap_queue=a.cap_queue, span=self._steps_per_tick * a.dt,
            )
            for tr in self._traj:
                tr["mpc_used"] = []
                tr["confident"] = []
        t0 = time.perf_counter()
        while self.sim.step_index < a.steps:
            w = self.sim.step_window(self.k, self._steps_per_tick)
            warm = w["t0"] >= self.scenarios[0].warmup
            if warm:
                self._windows_warm += 1
            meas, sojourn = self._window_measurement(w)
            with np.errstate(invalid="ignore"):
                miss_mask = (sojourn > t_max) & warm
            if warm:
                self._miss += miss_mask.astype(np.int64)
            if self.controlled:
                batch = ctl.tick_batch(meas, self.k, self.static, self._params(),
                                       ensure=hooks, proactive=pc, q_backlog=w["q_final"],
                                       compact_state=cstate)
                for bi, row in enumerate(batch.rows):
                    s = self.scenarios[bi]
                    self.decisions[bi].append(
                        self._to_decision(bi, row, meas, batch.errors[bi]))
                    if row.applied:
                        self.k[bi, : s.graph.n] = row.k_next
            for bi, s in enumerate(self.scenarios):
                tr = self._traj[bi]
                tr["t"].append(float(self.sim.now))
                tr["k_total"].append(int(self.k[bi, : s.graph.n].sum()))
                tr["miss"].append(bool(miss_mask[bi]))
                tr["sojourn"].append(float(sojourn[bi]))
                tr["warm"].append(bool(warm))
                if pc is not None:
                    tr["mpc_used"].append(bool(pc.mpc_used[bi]))
                    tr["confident"].append(bool(pc.confident[bi]))
        self.loop_seconds = time.perf_counter() - t0
        self._result = self.sim.result()
        return self.reports()

    def _run_fused(self) -> list[ScenarioReport]:
        """The fused path: every control window through
        :func:`~repro_torch.core.controller.make_fused_loop`."""
        from ..streaming.batchsim import BatchSimResult

        a = self.arrays
        loop, n_ticks = ctl.make_fused_loop(
            a, self.static, self.params, steps_per_tick=self._steps_per_tick,
            warmup_seconds=self.scenarios[0].warmup, proactive=self.proactive_cfg,
            compact=self.compact, mesh=self.mesh, device=self.device, dtype=self.dtype,
        )
        state = loop.init(self.k)
        t0 = time.perf_counter()
        _, out = loop.run(state)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.loop_seconds = time.perf_counter() - t0
        out = {key: (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
               for key, v in loop.gather(out).items()}
        self.outputs = out  # the loop's per-tick outputs and aggregates (numpy)
        self.k = out["k_final"].astype(np.int64)
        self._windows_warm = int(out["warm_windows"])
        self._miss = np.where(
            [s.t_max is not None for s in self.scenarios], out["miss"], 0
        ).astype(np.int64)
        t_max = np.array([np.nan if s.t_max is None else s.t_max for s in self.scenarios])
        if self.proactive_cfg is not None:
            for tr in self._traj:
                tr["mpc_used"] = []
                tr["confident"] = []
        for ti in range(n_ticks):
            now = (ti + 1) * self._steps_per_tick * a.dt
            warm = (ti * self._steps_per_tick * a.dt) >= self.scenarios[0].warmup
            for bi, s in enumerate(self.scenarios):
                k_row = out["k"][ti, bi, : s.graph.n].astype(np.int64)
                applied = bool(out["applied"][ti, bi])
                soj = float(out["sojourn"][ti, bi])
                self.decisions[bi].append(SchedulerDecision(
                    now, ctl.ACTIONS[int(out["codes"][ti, bi])], k_row,
                    k_row if applied else None, s.k_max,
                    float(out["et_cur"][ti, bi]), float(out["et_target"][ti, bi]), soj,
                ))
                with np.errstate(invalid="ignore"):
                    missed = bool((soj > t_max[bi]) and warm)
                tr = self._traj[bi]
                tr["t"].append(now)
                tr["k_total"].append(int(k_row.sum()))
                tr["miss"].append(missed)
                tr["sojourn"].append(soj)
                tr["warm"].append(bool(warm))
                if self.proactive_cfg is not None:
                    tr["mpc_used"].append(bool(out["mpc_used"][ti, bi]))
                    tr["confident"].append(bool(out["confident"][ti, bi]))
        warm_steps = max(a.steps - a.warmup_steps, 0)
        self._result = BatchSimResult(
            offered=out["offered"], served=out["served"], dropped=out["dropped"],
            ext_admitted=out["ext_admitted"], ext_offered=out["ext_offered"],
            q_final=out["q_final"], q_mean=out["q_int"] / max(warm_steps, 1),
            max_backlog=out["q_max"], span=warm_steps * a.dt, dt=a.dt,
        )
        return self.reports()

    def reports(self) -> list[ScenarioReport]:
        from ..core.allocator import InsufficientResourcesError, allocate
        from ..core.jackson import UnstableTopologyError

        res = self._result
        if res is None:
            raise RuntimeError("run() the loop before asking for reports")
        a = self.arrays
        sojourns = res.sojourn(self.k, a.mu, a.group, a.alpha, a.speed, ca2=a.ca2, cs2=a.cs2)
        sat = res.saturated(self.k, a.mu, a.group, a.alpha, a.speed)
        optimal: dict[int, int | None] = {}
        out = []
        for bi, s in enumerate(self.scenarios):
            n = s.graph.n
            if id(s) not in optimal:
                try:
                    optimal[id(s)] = int(
                        allocate(s.mean_topology(), k_max=s.k_max, t_max=s.t_max).total
                    )
                except (InsufficientResourcesError, UnstableTopologyError):
                    optimal[id(s)] = None
            offered = float(res.offered[bi, :n].sum())
            dropped = float(res.dropped[bi, :n].sum())
            decs = self.decisions[bi]
            out.append(ScenarioReport(
                name=s.name,
                actions=tuple(d.action for d in decs),
                allocations=tuple(
                    dict(zip(s.graph.names, map(int, d.k_current))) for d in decs
                ),
                k_final=dict(zip(s.graph.names, map(int, self.k[bi, :n]))),
                provisioned_total=int(self.k[bi, :n].sum()),
                optimal_total=optimal[id(s)],
                deadline_miss_rate=(
                    float(self._miss[bi] / self._windows_warm)
                    if (self._windows_warm and s.t_max is not None) else float("nan")
                ),
                drop_rate=dropped / max(offered, 1e-300),
                mean_sojourn=float(sojourns[bi]),
                saturated=tuple(nm for i, nm in enumerate(s.graph.names) if sat[bi, i]),
                trajectory=self._traj[bi] if self._traj[bi]["t"] else None,
            ))
        return out
