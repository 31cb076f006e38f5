"""Sessions: one AppGraph bound to a backend, and the scenario runner.

* :class:`DRSSession` owns the live measure -> model -> rebalance loop of
  ``repro.api.session.DRSSession`` on the :class:`EngineBackend` (the
  threaded :class:`~repro_torch.streaming.engine.StreamEngine`): it builds
  the :class:`~repro_torch.core.scheduler.DRSScheduler` from the graph,
  wires the engine's measurer to it, and applies each tick's decision to
  the running workers.  ``DRSSession.bind(graph, "engine")`` runs the
  operators' kernels on the CUDA device unless given ``device="cpu"``.
* :class:`ScenarioRunner` sweeps a matrix of scenarios through the closed
  control loop (the fused path of ``repro.api.session.ScenarioRunner``):
  every ``tick_interval`` of simulated time the fleet advances one window
  through :func:`~repro_torch.core.controller.make_fused_loop` and the
  runner turns the per-tick outputs into :class:`ScenarioReport`s.

Typical live use::

    session = DRSSession.bind(graph, "engine", config=SchedulerConfig(k_max=6))
    session.start({"extract": 1, "match": 2, "aggregate": 1})
    ...inject tuples...
    session.tick()          # pulls measurements, decides, applies rescale
    session.drain(); session.stop()
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from ..core import controller as ctl
from ..core.allocator import AllocationResult, allocate
from ..core.jackson import Topology
from ..core.measurer import Measurer
from ..core.negotiator import Negotiator
from ..core.rebalance import ExecutableCache, RebalanceCostModel
from ..core.scheduler import (
    PROACTIVE_NOT_PORTED, DRSScheduler, SchedulerConfig, SchedulerDecision,
)
from ..device import resolve_device
from .graph import AppGraph, GraphValidationError

__all__ = ["SchedulerConfig", "SchedulerDecision", "EngineBackend", "DRSSession",
           "ScenarioReport", "ScenarioRunner"]

DES_NOT_PORTED = (
    "the discrete-event backend ('des') is not ported to repro_torch yet: "
    "ROADMAP.md Queue 1 item 12; bind the live 'engine' backend"
)


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


_BACKENDS = {"engine": EngineBackend}


class DRSSession:
    """One AppGraph + one live backend + the DRS control loop.

    Construction wires the scheduler from the graph (names, routing
    matrix, scaling modes) and the backend's measurer.  ``tick()`` pulls,
    models, decides, and *applies* the decision to the backend.
    """

    def __init__(
        self,
        graph: AppGraph,
        backend: EngineBackend,
        *,
        config: SchedulerConfig | None = None,
        negotiator: Negotiator | None = None,
        cost_model: RebalanceCostModel | None = None,
        executable_cache: ExecutableCache | None = None,
        on_decision=None,
        proactive=None,
    ):
        if proactive is not None:
            raise NotImplementedError(PROACTIVE_NOT_PORTED)
        self.graph = graph
        self.backend = backend
        self.config = config or SchedulerConfig()
        self.negotiator = negotiator
        self.cost_model = cost_model
        self.executable_cache = executable_cache
        self.on_decision = on_decision
        self.scheduler: DRSScheduler | None = None

    @classmethod
    def bind(cls, graph: AppGraph, backend: Any = "engine", **kwargs) -> "DRSSession":
        """Bind ``graph`` to ``backend`` (``"engine"`` or a built
        :class:`EngineBackend`).  Session options (``config=``,
        ``negotiator=``, ``cost_model=``, ``executable_cache=``,
        ``on_decision=``) are taken from ``kwargs``; the rest go to the
        backend (``device=``, ``queue_capacity=``, ``overload_policy=``).
        ``"des"`` raises: the discrete-event backend is not ported."""
        session_keys = ("config", "negotiator", "cost_model", "executable_cache",
                        "on_decision", "proactive")
        session_kw = {k: kwargs.pop(k) for k in session_keys if k in kwargs}
        if isinstance(backend, str):
            if backend == "des":
                raise GraphValidationError(DES_NOT_PORTED)
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
        if decision.action in ("rebalance", "scale_out", "scale_in", "overloaded"):
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
        return self.backend.inject(payload, source=source, timeout=timeout)

    def drain(self, timeout: float = 10.0) -> bool:
        return self.backend.drain(timeout=timeout)

    def stop(self) -> None:
        self.backend.stop()

    @property
    def completed_sojourns(self) -> list[float]:
        return self.backend.completed_sojourns

    def drop_counts(self) -> dict[str, int]:
        """Cumulative tuples shed per operator."""
        return self.backend.drop_counts()


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
    """Sweep static-budget scenarios through the fused control loop.

    ``device`` defaults to the CUDA device (raising when there is none);
    ``dtype`` to float32, the kernels' type.  Negotiated scenarios lease
    machines between ticks, which the fused loop cannot do: they raise
    :class:`GraphValidationError`, as the reference's ``fused=True`` gate
    does.  A scenario object repeated in ``scenarios`` is planned and
    sampled once (fleets may tile a few distinct scenarios).
    """

    def __init__(self, scenarios: Sequence, *, tick_interval: float = 10.0,
                 fused_decide: bool = False, device=None, dtype=None):
        from ..streaming.scenarios import pack_allocations, pack_scenarios

        self.device = resolve_device(device)
        self.dtype = torch.float32 if dtype is None else dtype
        self.scenarios = list(scenarios)
        self.tick_interval = tick_interval
        self.fused_decide = bool(fused_decide)
        negotiated = [s.name for s in self.scenarios if s.negotiated]
        self.arrays = pack_scenarios(self.scenarios)
        self._steps_per_tick = max(int(round(tick_interval / self.arrays.dt)), 1)
        if negotiated or self.arrays.steps % self._steps_per_tick:
            raise GraphValidationError(
                "the fused loop needs static-budget scenarios and a horizon "
                "divisible by the tick interval; negotiated scenarios: "
                f"{negotiated}"
            )
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
        self.params = ctl.ControllerParams.stack(
            [
                SchedulerConfig(k_max=s.k_max, t_max=s.t_max, tick_interval=tick_interval,
                                allocator=s.allocator, fused_decide=self.fused_decide)
                for s in self.scenarios
            ],
            [s.k_max for s in self.scenarios],
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

    def run(self) -> list[ScenarioReport]:
        from ..streaming.batchsim import BatchSimResult

        a = self.arrays
        loop, n_ticks = ctl.make_fused_loop(
            a, self.static, self.params, steps_per_tick=self._steps_per_tick,
            warmup_seconds=self.scenarios[0].warmup, device=self.device, dtype=self.dtype,
        )
        state = loop.init(self.k)
        t0 = time.perf_counter()
        _, out = loop.run(state)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.loop_seconds = time.perf_counter() - t0
        out = {key: (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
               for key, v in out.items()}
        self.outputs = out  # the loop's per-tick outputs and aggregates (numpy)
        self.k = out["k_final"].astype(np.int64)
        self._windows_warm = int(out["warm_windows"])
        self._miss = np.where(
            [s.t_max is not None for s in self.scenarios], out["miss"], 0
        ).astype(np.int64)
        t_max = np.array([np.nan if s.t_max is None else s.t_max for s in self.scenarios])
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
