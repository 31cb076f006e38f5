"""The scenario runner: a matrix of scenarios through the closed control
loop (the fused path of ``repro.api.session.ScenarioRunner``).

Every ``tick_interval`` of simulated time the fleet advances one window
through :func:`~repro_torch.core.controller.make_fused_loop` -- simulate,
measure, decide, apply -- and the runner turns the per-tick outputs into
per-scenario decisions and :class:`ScenarioReport`s (deadline-miss rate,
drop rate, provisioned vs Program-(4)/(6)-optimal resources).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..core import controller as ctl
from ..device import resolve_device
from .graph import GraphValidationError

__all__ = ["SchedulerConfig", "SchedulerDecision", "ScenarioReport", "ScenarioRunner"]


@dataclass(frozen=True)
class SchedulerConfig:
    """The decision parameters :meth:`ControllerParams.stack` reads (the
    fields and defaults of ``repro.core.scheduler.SchedulerConfig``)."""

    t_max: float | None = None  # real-time constraint (seconds); None = Program 4 only
    k_max: int | None = None  # static budget
    horizon_seconds: float = 300.0  # cost/benefit planning horizon
    scale_in_hysteresis: float = 0.8
    min_improvement: float = 0.05  # rebalance only if E[T] improves by >= 5%
    headroom: float = 1.1
    tick_interval: float = 10.0
    allocator: str = "table"
    fused_decide: bool = False  # Program 4 through kernels/decide_fused


@dataclass(frozen=True)
class SchedulerDecision:
    """One scenario's decision at one tick."""

    t: float
    action: str
    k_current: np.ndarray  # allocation in force after the tick
    k_target: np.ndarray | None  # the applied allocation, when one was applied
    k_max: int
    model_sojourn_current: float
    model_sojourn_target: float | None
    measured_sojourn: float


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
