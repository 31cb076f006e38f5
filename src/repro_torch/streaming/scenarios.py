"""Scenario matrix -- declarative, seed-deterministic workload scenarios.

A :class:`Scenario` pins what one simulated experiment needs (AppGraph x
arrival trace x service kind x overload policy x allocator x seed) and
compiles to either simulator: :meth:`Scenario.simulator` gives the event
DES (:class:`~repro_torch.streaming.des.NetworkSimulator`) and
:func:`pack_scenarios` compiles a batch to
:class:`~repro_torch.streaming.batchsim.BatchArrays`.  :class:`ArrivalTrace`
is the trace zoo (constant, diurnal sinusoid, flash-crowd step, 2-state
MMPP, replay), :func:`random_appgraph` the random-topology zoo, and
:func:`scenario_matrix` crosses the axes.  Everything here is host-side
numpy and draws its randomness exactly as ``repro/streaming/scenarios.py``
does, so the same seed gives the same scenarios and arrival counts in both
packages.  :func:`control_trace` is the golden-trace surface, run through
this package's :class:`~repro_torch.api.session.ScenarioRunner`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Mapping, Sequence

import numpy as np

from ..api.graph import AppGraph, Edge, OpDef
from .batchsim import BatchArrays
from .overload import OverloadPolicy

__all__ = [
    "ArrivalTrace",
    "Scenario",
    "random_appgraph",
    "scenario_matrix",
    "pack_scenarios",
    "pack_allocations",
    "control_trace",
    "vld_scenario",
    "fpd_scenario",
]


@dataclass(frozen=True)
class ArrivalTrace:
    """A deterministic rate schedule lambda_0(t) for one source operator:
    ``constant``, ``diurnal`` (``rate + amplitude * sin(2 pi t / period)``,
    clamped at 0), ``flash`` (``peak`` on ``[t_on, t_off)``), ``mmpp``
    (2-state Markov-modulated, state path sampled once from the seed) or
    ``replay`` (``samples`` at ``sample_dt`` spacing)."""

    kind: str = "constant"
    rate: float = 10.0
    peak: float | None = None
    amplitude: float = 0.0
    period: float = 60.0
    t_on: float = 0.0
    t_off: float = 0.0
    switch01: float = 0.1
    switch10: float = 0.1
    samples: tuple = ()
    sample_dt: float = 1.0

    _KINDS = ("constant", "diurnal", "flash", "mmpp", "replay")

    def __post_init__(self):
        if self.kind not in self._KINDS:
            raise ValueError(f"unknown trace kind {self.kind!r}; expected {self._KINDS}")
        if self.rate < 0:
            raise ValueError(f"trace rate must be >= 0, got {self.rate}")
        if self.kind in ("flash", "mmpp") and self.peak is None:
            raise ValueError(f"trace kind {self.kind!r} needs peak=")
        if self.kind == "replay" and not self.samples:
            raise ValueError("replay trace needs samples=")

    def rates(self, t_grid, seed: int = 0) -> np.ndarray:
        """lambda_0 at each grid time -- [T] float64, deterministic given
        (trace, seed)."""
        t = np.asarray(t_grid, dtype=np.float64)
        if self.kind == "constant":
            return np.full(t.shape, self.rate)
        if self.kind == "diurnal":
            return np.maximum(
                self.rate + self.amplitude * np.sin(2.0 * math.pi * t / self.period), 0.0
            )
        if self.kind == "flash":
            return np.where((t >= self.t_on) & (t < self.t_off), self.peak, self.rate)
        if self.kind == "replay":
            idx = np.clip((t / self.sample_dt).astype(np.int64), 0, len(self.samples) - 1)
            return np.asarray(self.samples, dtype=np.float64)[idx]
        # mmpp: sample the modulating state path once, from its own stream.
        rng = np.random.default_rng(np.random.SeedSequence([seed, 0x3A7E]))
        rates = np.empty(t.shape)
        state, now = 0, float(t[0]) if t.size else 0.0
        sw = (self.switch01, self.switch10)
        t_next = now + (rng.exponential(1.0 / sw[0]) if sw[0] > 0 else math.inf)
        for i, ti in enumerate(t):
            while ti >= t_next:
                state = 1 - state
                s = sw[state]
                t_next += rng.exponential(1.0 / s) if s > 0 else math.inf
            rates[i] = self.rate if state == 0 else self.peak
        return rates

    def mean_rate(self, horizon: float, seed: int = 0, dt: float = 0.5) -> float:
        """Time-averaged rate over [0, horizon] (trapezoid on a ``dt`` grid)."""
        span = max(horizon, dt)
        grid = np.arange(0.0, span + dt / 2.0, dt)
        r = self.rates(grid, seed)
        integral = 0.5 * (r[1:] + r[:-1]).sum() * dt
        return float(integral / (grid[-1] - grid[0]))

    def des_schedule(self, horizon: float, seed: int = 0, dt: float = 1.0):
        """(initial ``ArrivalProcess`` kwargs, [(t, rate), ...] mid-run
        changes): the trace as the event DES runs it, its rate grid at
        ``dt`` spacing turned into ``schedule_arrival_change`` calls."""
        if self.kind == "constant":
            return {"rate": self.rate}, []
        grid = np.arange(0.0, horizon + dt, dt)
        rates = self.rates(grid, seed)
        changes = []
        last = rates[0]
        for t, r in zip(grid[1:], rates[1:]):
            if r != last:
                changes.append((float(t), float(r)))
                last = r
        return {"rate": float(rates[0])}, changes


def random_appgraph(
    seed: int,
    *,
    n_ops: tuple[int, int] = (3, 7),
    p_split: float = 0.35,
    p_join: float = 0.35,
    p_loop: float = 0.3,
    target_rho: tuple[float, float] = (0.3, 0.8),
    lam0: float = 10.0,
    n_sources: int = 1,
) -> AppGraph:
    """A valid random :class:`AppGraph` with splits, joins and leaking loops
    (spectral radius kept below 0.9); service rates put utilisation at a
    handful of processors inside ``target_rho``."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x70B0]))
    n = int(rng.integers(n_ops[0], n_ops[1] + 1))
    names = [f"op{i}" for i in range(n)]
    routing = np.zeros((n, n))
    n_src = min(n_sources, n)
    for j in range(n_src, n):  # spine: every op reachable from a source
        i = int(rng.integers(0, j))
        routing[i, j] = 1.0
    for i in range(n - 1):  # splits
        if rng.random() < p_split:
            choices = [j for j in range(i + 1, n) if routing[i, j] == 0.0]
            if choices:
                j = int(rng.choice(choices))
                routing[i, j] = float(rng.uniform(0.2, 1.2))
    for j in range(n_src + 1, n):  # joins
        if rng.random() < p_join:
            choices = [i for i in range(j) if routing[i, j] == 0.0]
            if choices:
                i = int(rng.choice(choices))
                routing[i, j] = float(rng.uniform(0.2, 0.9))
    if rng.random() < p_loop:  # one leaking self-loop or back-edge
        i = int(rng.integers(0, n))
        if rng.random() < 0.5 or i == 0:
            li, lj = i, i
            routing[i, i] = float(rng.uniform(0.1, 0.5))
        else:
            li, lj = i, int(rng.integers(0, i))
            routing[li, lj] = float(rng.uniform(0.1, 0.4))
        for _ in range(60):
            radius = float(max(abs(np.linalg.eigvals(routing))))
            if radius < 0.9:
                break
            routing[li, lj] *= 0.7
    lam0_vec = np.zeros(n)
    for s in range(n_src):
        lam0_vec[s] = lam0 / n_src
    lam = np.linalg.solve(np.eye(n) - routing.T, lam0_vec)
    lam = np.maximum(lam, 0.0)
    mus = np.empty(n)
    for i in range(n):
        rho = float(rng.uniform(*target_rho))
        k_nom = int(rng.integers(1, 5))
        mus[i] = (max(lam[i] / (rho * k_nom), 1e-3) if lam[i] > 0
                  else float(rng.uniform(1.0, 10.0)))
    ops = [OpDef(name=names[i], mu=float(mus[i])) for i in range(n)]
    edges = [
        Edge(names[i], names[j], multiplicity=float(routing[i, j]))
        for i in range(n) for j in range(n) if routing[i, j] > 0.0
    ]
    sources = {names[s]: float(lam0_vec[s]) for s in range(n_src) if lam0_vec[s] > 0}
    return AppGraph(ops, edges, sources)


@dataclass(frozen=True)
class Scenario:
    """One fully pinned experiment.  ``traces`` maps source operators to
    :class:`ArrivalTrace`s; ``arrival_kind`` is the micro inter-arrival law
    (``exponential``/``uniform`` sample Poisson step counts,
    ``deterministic`` uses exact fluid mass); ``k0`` is the starting
    allocation (None = plan Program (4)/(6) on the declared priors).
    ``negotiated`` scenarios lease ``machine_size``-processor machines from
    a pool of ``k_max`` through a negotiator instead of holding a static
    budget; only the window-at-a-time loop runs them (see
    :class:`~repro_torch.api.session.ScenarioRunner`)."""

    name: str
    graph: AppGraph
    traces: Mapping[str, ArrivalTrace] = field(default_factory=dict)
    arrival_kind: str = "exponential"
    service_kind: str = "exponential"
    overload_policy: OverloadPolicy | str = "shed-newest"
    allocator: str = "table"
    seed: int = 0
    horizon: float = 120.0
    warmup: float = 10.0
    dt: float = 0.05
    queue_capacity: int | None = None
    k_max: int = 64
    t_max: float | None = None
    k0: Mapping[str, int] | None = None
    negotiated: bool = False
    machine_size: int = 4
    speed_factors: Mapping[str, float] | None = None

    _ARRIVAL_KINDS = ("exponential", "uniform", "deterministic")
    _SERVICE_KINDS = ("exponential", "uniform", "deterministic", "lognormal")
    _ALLOCATORS = ("table", "heap")
    # Squared coefficients of variation of the micro laws (Allen-Cunneen
    # inputs): exponential 1, uniform on [0, 2m] 1/3, deterministic 0,
    # lognormal cv^2 = 1.
    _ARRIVAL_SCV = {"exponential": 1.0, "uniform": 1.0 / 3.0, "deterministic": 0.0}
    _SERVICE_SCV = {
        "exponential": 1.0, "uniform": 1.0 / 3.0, "deterministic": 0.0, "lognormal": 1.0,
    }

    def __post_init__(self):
        OverloadPolicy.coerce(self.overload_policy)  # validate early
        unknown = set(self.traces) - set(self.graph.names)
        if unknown:
            raise ValueError(f"traces for unknown operators: {sorted(unknown)}")
        if self.speed_factors is not None:
            unknown = set(self.speed_factors) - set(self.graph.names)
            if unknown:
                raise ValueError(f"speed_factors for unknown operators: {sorted(unknown)}")
            bad = {k: v for k, v in self.speed_factors.items() if not v > 0}
            if bad:
                raise ValueError(f"speed_factors must be > 0, got {bad}")
        if self.arrival_kind not in self._ARRIVAL_KINDS:
            raise ValueError(f"unknown arrival_kind {self.arrival_kind!r}")
        if self.service_kind not in self._SERVICE_KINDS:
            raise ValueError(f"unknown service_kind {self.service_kind!r}")
        if self.allocator not in self._ALLOCATORS:
            raise ValueError(f"unknown allocator {self.allocator!r}")
        if self.dt <= 0 or self.horizon <= 0 or not 0 <= self.warmup < self.horizon:
            raise ValueError(
                f"need dt > 0, horizon > 0, 0 <= warmup < horizon; got "
                f"dt={self.dt}, horizon={self.horizon}, warmup={self.warmup}"
            )

    @property
    def policy(self) -> OverloadPolicy:
        return OverloadPolicy.coerce(self.overload_policy)

    @property
    def arrival_scv(self) -> float:
        return self._ARRIVAL_SCV[self.arrival_kind]

    @property
    def service_scv(self) -> float:
        return self._SERVICE_SCV[self.service_kind]

    @property
    def steps(self) -> int:
        return int(round(self.horizon / self.dt))

    def with_(self, **kw) -> "Scenario":
        return replace(self, **kw)

    def rate_grid(self) -> np.ndarray:
        """[T, N] external arrival rate per step for every operator."""
        t_grid = (np.arange(self.steps) + 0.5) * self.dt
        rates = np.zeros((self.steps, self.graph.n))
        lam0 = self.graph.lam0_vector()
        for i, name in enumerate(self.graph.names):
            trace = self.traces.get(name)
            if trace is not None:
                rates[:, i] = trace.rates(t_grid, self.seed)
            elif lam0[i] > 0:
                rates[:, i] = lam0[i]
        return rates

    def sample_arrivals(self) -> np.ndarray:
        """[T, N] pre-sampled external arrival counts per step (Poisson
        around the trace rate, or exact fluid mass for ``deterministic``)."""
        rates = self.rate_grid()
        if self.arrival_kind == "deterministic":
            return rates * self.dt
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 0xA881]))
        return rng.poisson(rates * self.dt).astype(np.float64)

    def speed_vector(self) -> np.ndarray | None:
        """[N] machine-class speed factors (None when homogeneous)."""
        if self.speed_factors is None:
            return None
        return np.array([float(self.speed_factors.get(n, 1.0)) for n in self.graph.names])

    def mean_topology(self):
        """Model Topology at the traces' time-averaged rates, with the
        machine-class speed factors applied."""
        sources = {}
        lam0 = self.graph.lam0_vector()
        for i, name in enumerate(self.graph.names):
            trace = self.traces.get(name)
            if trace is not None:
                sources[name] = trace.mean_rate(self.horizon, self.seed)
            elif lam0[i] > 0:
                sources[name] = float(lam0[i])
        g = self.graph.with_sources(sources)
        if self.speed_factors is None:
            return g.topology()
        return g.topology(
            {op.name: op.mu * float(self.speed_factors.get(op.name, 1.0)) for op in g.ops}
        )

    def simulator(self, k, *, measurer=None, seed: int | None = None):
        """The event-DES twin of this scenario: same topology, rate
        schedule and overload policy, its own process randomness.
        ``seed`` overrides the DES process randomness only; the trace
        realization stays pinned to the scenario seed."""
        from ..api.session import _group_effective_services
        from .des import ArrivalProcess, NetworkSimulator, ServiceProcess, SimConfig

        if self.speed_factors is None:
            top = self.graph.topology()
        else:
            top = self.graph.topology(
                {op.name: op.mu * float(self.speed_factors.get(op.name, 1.0))
                 for op in self.graph.ops}
            )
        k_vec = self.graph.k_vector(k)
        arrivals = []
        changes: list[tuple[float, int, float]] = []
        lam0 = self.graph.lam0_vector()
        for i, name in enumerate(self.graph.names):
            trace = self.traces.get(name)
            if trace is None:
                arrivals.append(ArrivalProcess(rate=float(lam0[i]), kind=self.arrival_kind))
                continue
            kw, sched = trace.des_schedule(self.horizon, self.seed)
            arrivals.append(ArrivalProcess(rate=kw["rate"], kind=self.arrival_kind))
            changes.extend((t, i, r) for t, r in sched)
        # Chip-gang operators collapse to one effective server, as in the
        # DES backend and the batch simulator's capacity rule.
        services, k_eff = _group_effective_services(top, k_vec)
        services = [ServiceProcess(rate=svc.rate, kind=self.service_kind) for svc in services]
        sim = NetworkSimulator(
            top,
            k_eff,
            config=SimConfig(
                seed=self.seed if seed is None else int(seed),
                horizon=self.horizon,
                warmup=self.warmup,
                queue_capacity=self.queue_capacity,
                overload_policy=self.overload_policy,
            ),
            arrivals=arrivals,
            services=services,
            measurer=measurer,
        )
        for t, i, r in changes:
            sim.schedule_arrival_change(t, i, r)
        return sim

    def plan_k0(self) -> np.ndarray:
        """Starting allocation: declared ``k0`` or Program (4)/(6) on priors."""
        from ..core.allocator import allocate

        if self.k0 is not None:
            return self.graph.k_vector(self.k0)
        return allocate(self.mean_topology(), k_max=self.k_max, t_max=self.t_max).k


def pack_scenarios(scenarios: Sequence[Scenario], *, pad_to: int | None = None) -> BatchArrays:
    """Pack B scenarios (shared dt/horizon/warmup) into one batch; narrower
    scenarios get inactive zero-traffic lanes (mu = 1, no routing).  A
    scenario object that repeats in the sequence is sampled once.
    ``pad_to`` pads the batch axis to that extent with inert scenario lanes
    (``BatchArrays.pad_batch``: a fleet mesh needs B to be a multiple of
    its rank count)."""
    if not scenarios:
        raise ValueError("need at least one scenario")
    dts = {s.dt for s in scenarios}
    horizons = {s.horizon for s in scenarios}
    warmups = {s.warmup for s in scenarios}
    if len(dts) > 1 or len(horizons) > 1 or len(warmups) > 1:
        raise ValueError(
            "batch scenarios must share dt/horizon/warmup; got "
            f"dt={sorted(dts)}, horizon={sorted(horizons)}, warmup={sorted(warmups)}"
        )
    b = len(scenarios)
    n = max(s.graph.n for s in scenarios)
    steps = scenarios[0].steps
    dt = scenarios[0].dt
    ext = np.zeros((steps, b, n))
    routing = np.zeros((b, n, n))
    mu = np.ones((b, n))
    group = np.zeros((b, n), dtype=bool)
    alpha = np.zeros((b, n))
    cap_queue = np.full((b, n), np.inf)
    active = np.zeros((b, n), dtype=bool)
    speed = np.ones((b, n))
    ca2 = np.ones((b, n))
    cs2 = np.ones((b, n))
    heterogeneous = False
    sampled: dict[int, np.ndarray] = {}
    for bi, s in enumerate(scenarios):
        ni = s.graph.n
        if id(s) not in sampled:
            sampled[id(s)] = s.sample_arrivals()
        ext[:, bi, :ni] = sampled[id(s)]
        routing[bi, :ni, :ni] = s.graph.routing_matrix()
        ca2[bi, :ni] = s.arrival_scv
        cs2[bi, :ni] = s.service_scv
        for i, op in enumerate(s.graph.ops):
            mu[bi, i] = op.mu
            group[bi, i] = op.scaling == "group"
            alpha[bi, i] = op.group_alpha
        active[bi, :ni] = True
        if s.queue_capacity is not None and s.policy.sheds:
            cap_queue[bi, :ni] = float(s.queue_capacity)
        sv = s.speed_vector()
        if sv is not None:
            speed[bi, :ni] = sv
            heterogeneous = True
    arrays = BatchArrays(
        ext=ext, routing=routing, mu=mu, group=group, alpha=alpha, cap_queue=cap_queue,
        dt=dt, warmup_steps=int(round(scenarios[0].warmup / dt)), active=active,
        speed=speed if heterogeneous else None, ca2=ca2, cs2=cs2,
    )
    return arrays if pad_to is None else arrays.pad_batch(int(pad_to))


def pack_allocations(scenarios: Sequence[Scenario], ks) -> np.ndarray:
    """[B, N_max] allocation matrix from per-scenario k vectors/dicts
    (padding lanes get 0 processors)."""
    n = max(s.graph.n for s in scenarios)
    out = np.zeros((len(scenarios), n), dtype=np.int64)
    for bi, (s, k) in enumerate(zip(scenarios, ks)):
        out[bi, : s.graph.n] = s.graph.k_vector(k)
    return out


def vld_scenario(**kw) -> Scenario:
    """The paper's VLD chain (extract -> match -> aggregate) as a model-only
    scenario under a flash crowd."""
    graph = AppGraph(
        [OpDef("extract", mu=2.0), OpDef("match", mu=5.0), OpDef("aggregate", mu=50.0)],
        [Edge("extract", "match"), Edge("match", "aggregate")],
        {"extract": 13.0},
        arrival_kind="uniform",
    )
    defaults = dict(
        name="vld",
        graph=graph,
        traces={"extract": ArrivalTrace(kind="flash", rate=10.0, peak=20.0,
                                        t_on=60.0, t_off=90.0)},
        arrival_kind="uniform",
        seed=7,
        horizon=150.0,
        warmup=10.0,
        k_max=48,
        t_max=2.5,
        negotiated=True,
    )
    defaults.update(kw)
    return Scenario(**defaults)


def fpd_scenario(**kw) -> Scenario:
    """The paper's FPD graph (generate -> detect[self-loop] -> report) as a
    model-only negotiated scenario under a diurnal trace."""
    loop_p = 0.3
    graph = AppGraph(
        [OpDef("generate", mu=4.0), OpDef("detect", mu=3.0), OpDef("report", mu=12.0)],
        [
            Edge("generate", "detect"),
            Edge("detect", "detect", multiplicity=loop_p),
            Edge("detect", "report", multiplicity=1.0 - loop_p),
        ],
        {"generate": 16.0},
    )
    defaults = dict(
        name="fpd",
        graph=graph,
        traces={"generate": ArrivalTrace(kind="diurnal", rate=14.0, amplitude=8.0,
                                         period=80.0)},
        seed=11,
        horizon=160.0,
        warmup=10.0,
        k_max=64,
        t_max=3.0,
        negotiated=True,
    )
    defaults.update(kw)
    return Scenario(**defaults)


def control_trace(
    scenarios: Sequence[Scenario],
    *,
    tick_interval: float = 10.0,
    proactive=None,
    backend: str = "torch",
    fused_decide: bool = False,
    compact=None,
    device=None,
    dtype=None,
) -> dict:
    """JSON-able decision trace of the control loop over ``scenarios`` (the
    golden-trace schema of ``repro.streaming.scenarios.control_trace``): per
    scenario the action sequence, the allocation in force after every tick
    and the per-tick trajectory (with ``mpc_used`` / ``confident`` when
    ``proactive``, True or an :class:`~repro_torch.forecast.mpc.MPCConfig`).

    ``backend="torch"`` (the default) runs on ``device`` (default: the CUDA
    device) in ``dtype``: the fused loop when the scenarios allow it
    (static budgets, a horizon divisible by the tick), else the
    window-at-a-time loop over ``BatchQueueSim``'s torch window.
    ``backend="numpy"`` is the reference's float64 twin, on the host.
    ``compact`` (True or a
    :class:`~repro_torch.core.controller.CompactionConfig`) runs the sparse
    decide, which leaves every trace unchanged."""
    from ..api.session import ScenarioRunner

    reports = ScenarioRunner(
        scenarios, tick_interval=tick_interval, backend=backend, proactive=proactive,
        fused_decide=fused_decide, compact=compact, device=device, dtype=dtype,
    ).run()

    def _traj(tr):
        if tr is None:
            return None
        out = {
            "t": [round(float(t), 9) for t in tr["t"]],
            "k_total": list(tr["k_total"]),
            "miss": [int(m) for m in tr["miss"]],
            "warm": [int(w) for w in tr["warm"]],
        }
        if "mpc_used" in tr:
            out["mpc_used"] = [int(u) for u in tr["mpc_used"]]
            out["confident"] = [int(c) for c in tr["confident"]]
        return out

    return {
        "tick_interval": tick_interval,
        "proactive": proactive is not None,
        "scenarios": {
            r.name: {
                "actions": list(r.actions),
                "allocations": [dict(a) for a in r.allocations],
                "provisioned_total": r.provisioned_total,
                "optimal_total": r.optimal_total,
                "drop_rate": round(r.drop_rate, 9),
                "mean_sojourn": round(r.mean_sojourn, 9),
                "deadline_miss_rate": round(r.deadline_miss_rate, 9),
                "trajectory": _traj(r.trajectory),
            }
            for r in reports
        },
    }


def scenario_matrix(
    n_scenarios: int,
    *,
    seed: int = 0,
    horizon: float = 60.0,
    warmup: float = 5.0,
    dt: float = 0.05,
    k_max: int = 48,
) -> list[Scenario]:
    """A seeded sweep over (random topology x trace kind x overload policy
    x allocator); scenario ``i`` of seed ``s`` is always the same spec."""
    from ..core.allocator import InsufficientResourcesError, allocate
    from ..core.jackson import UnstableTopologyError

    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x5CE0]))
    policies = ("shed-newest", "shed-oldest", "block")
    out = []
    for i in range(n_scenarios):
        g_seed = int(rng.integers(0, 1 << 30))
        graph = random_appgraph(g_seed, lam0=float(rng.uniform(5.0, 20.0)))
        src = graph.source_names[0]
        base = float(graph.lam0_vector().sum())
        kind = ("constant", "diurnal", "flash", "mmpp")[i % 4]
        if kind == "constant":
            trace = ArrivalTrace(kind="constant", rate=base)
        elif kind == "diurnal":
            trace = ArrivalTrace(kind="diurnal", rate=base, amplitude=0.5 * base,
                                 period=float(rng.uniform(0.4 * horizon, horizon)))
        elif kind == "flash":
            trace = ArrivalTrace(kind="flash", rate=base, peak=2.0 * base,
                                 t_on=horizon * 0.4, t_off=horizon * 0.6)
        else:
            trace = ArrivalTrace(kind="mmpp", rate=0.7 * base, peak=1.8 * base,
                                 switch01=0.05, switch10=0.1)
        # Coprime cycle lengths decorrelate the axes.
        bounded = i % 5 < 2
        allocator = "heap" if i % 7 < 3 else "table"
        negotiated = i % 7 >= 5
        # ~3/5 of the matrix gets a real-time constraint: 1.5x the best E[T]
        # reachable within the budget at the mean rate.
        t_max = None
        if i % 5 < 3:
            try:
                sources = {src: trace.mean_rate(horizon, g_seed ^ 0x1234)}
                top = graph.with_sources(sources).topology()
                t_max = 1.5 * allocate(top, k_max=k_max).expected_sojourn
            except (InsufficientResourcesError, UnstableTopologyError):
                t_max = None
        out.append(
            Scenario(
                name=f"m{seed}-{i:03d}-{kind}",
                graph=graph,
                traces={src: trace},
                seed=g_seed ^ 0x1234,
                horizon=horizon,
                warmup=warmup,
                dt=dt,
                overload_policy=policies[i % 3],
                allocator=allocator,
                queue_capacity=int(rng.integers(50, 400)) if bounded else None,
                k_max=k_max,
                t_max=t_max,
                negotiated=negotiated,
            )
        )
    return out
