"""Day-scale checkpointed soak harness -- the counterpart of
``repro/streaming/soak.py``.

The fused control loop's state (:class:`~repro_torch.core.controller
.ControllerState`) is resumable: driving a composite day (a diurnal
baseline, two flash crowds and an MMPP bursty stretch, one deterministic
``kind="replay"`` trace) in ``checkpoint_every``-window chunks, with a
simulated crash, a :class:`~repro_torch.checkpoint.store.CheckpointStore`
restore and a freshly built loop between every chunk, must equal the
straight-through run bit for bit: decisions, allocations, measurements and
the whole-run aggregates (:func:`assert_bit_identical`).

:func:`run_straight` and :func:`run_checkpointed` run on ``device``
(default: the CUDA device, raising when there is none) in ``dtype``
(default float32).  Nothing samples fresh randomness at run time: the
trace, the pre-sampled arrival counts and the controller are pinned to the
:class:`SoakConfig` seed.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Any

import numpy as np
import torch

__all__ = [
    "DIAGNOSTIC_KEYS",
    "SoakConfig",
    "SoakReport",
    "assert_bit_identical",
    "build_scenario",
    "composite_day_samples",
    "run_checkpointed",
    "run_straight",
    "soak_report",
]

DAY = 86400.0

#: stitched-output keys stacked per control window (concatenated across
#: resume chunks) vs accumulated in the carry (last chunk == whole run).
PER_TICK_KEYS = ("codes", "k", "sojourn", "et_cur", "et_target", "applied")
SUMMED_KEYS = ("miss", "warm_windows")
AGGREGATE_KEYS = (
    "k_final", "q_final", "offered", "served", "dropped",
    "ext_admitted", "ext_offered", "q_int", "q_max",
)
#: Diagnostics outside the bit-identity contract: the sparse decide's memo
#: lives outside the checkpointed state, so every resume chunk starts cold
#: and reprices every lane on its first tick.  Decisions are unchanged; only
#: ``repriced`` shows the chunk boundaries.
DIAGNOSTIC_KEYS = ("repriced",)


@dataclass(frozen=True)
class SoakConfig:
    """One pinned soak run.  ``day`` must divide by ``tick_interval`` and
    ``tick_interval`` by ``dt`` (the fused loop's gate)."""

    day: float = DAY
    dt: float = 0.5
    tick_interval: float = 120.0
    base_rate: float = 8.0
    seed: int = 42
    # A tight static budget: the mean needs ~11 of the 14 and the flash /
    # MMPP peaks more than 14, so the day exercises rebalances, overload
    # reallocations, deadline misses and bounded-queue shedding.
    k_max: int = 14
    queue_capacity: int = 150
    checkpoint_every: int = 96  # control windows between crash + restore cycles
    name: str = "soak-day"

    @classmethod
    def smoke(cls) -> "SoakConfig":
        """Two "hours" with the same composite shape (the diurnal period
        scales with ``day``), a crash + restore every 16 windows."""
        return cls(day=7200.0, checkpoint_every=16, name="soak-smoke")

    @property
    def n_ticks(self) -> int:
        return int(round(self.day / self.tick_interval))


def composite_day_samples(cfg: SoakConfig, sample_dt: float = 1.0) -> np.ndarray:
    """The day's rate schedule on a ``sample_dt`` grid: a diurnal baseline
    (4 cycles across ``day``) + two flash-crowd boosts + an MMPP bursty
    stretch over the middle fifth, each from the ArrivalTrace zoo."""
    from .scenarios import ArrivalTrace

    base, day = cfg.base_rate, cfg.day
    grid = np.arange(0.0, day, sample_dt)
    diurnal = ArrivalTrace(
        kind="diurnal", rate=base, amplitude=0.4 * base, period=day / 4.0
    ).rates(grid)
    flash = np.zeros_like(grid)
    for t_on, t_off in ((0.30 * day, 0.35 * day), (0.70 * day, 0.72 * day)):
        flash += ArrivalTrace(
            kind="flash", rate=0.0, peak=0.8 * base, t_on=t_on, t_off=t_off
        ).rates(grid)
    mmpp = ArrivalTrace(
        kind="mmpp", rate=0.0, peak=0.5 * base,
        switch01=40.0 / day, switch10=80.0 / day,
    ).rates(grid, seed=cfg.seed)
    burst_window = (grid >= 0.45 * day) & (grid < 0.65 * day)
    return np.maximum(diurnal + flash + np.where(burst_window, mmpp, 0.0), 0.0)


def build_scenario(cfg: SoakConfig):
    """The soak pipeline: ingest -> parse (with a reprocessing self-loop)
    fanning out to a gang operator and a sink, under the composite replay
    trace.  ``t_max`` is 1.5x the best mean-rate sojourn reachable within
    the budget (the scenario_matrix convention)."""
    from ..api.graph import AppGraph, Edge, OpDef
    from ..core.allocator import InsufficientResourcesError, allocate
    from ..core.jackson import UnstableTopologyError
    from .scenarios import ArrivalTrace, Scenario

    graph = AppGraph(
        [
            OpDef("ingest", mu=4.0),
            OpDef("parse", mu=6.0),
            OpDef("gang", mu=3.0, scaling="group", group_alpha=0.05),
            OpDef("sink", mu=20.0),
        ],
        [
            Edge("ingest", "parse"),
            Edge("parse", "parse", multiplicity=0.2),
            Edge("parse", "gang", multiplicity=0.4),
            Edge("parse", "sink", multiplicity=0.4),
            Edge("gang", "sink"),
        ],
        {"ingest": cfg.base_rate},
    )
    trace = ArrivalTrace(
        kind="replay", samples=tuple(composite_day_samples(cfg)), sample_dt=1.0
    )
    s = Scenario(
        name=cfg.name, graph=graph, traces={"ingest": trace},
        seed=cfg.seed, horizon=cfg.day, warmup=cfg.tick_interval,
        dt=cfg.dt, k_max=cfg.k_max, queue_capacity=cfg.queue_capacity,
    )
    try:
        t_max = 1.5 * allocate(s.mean_topology(), k_max=cfg.k_max).expected_sojourn
    except (InsufficientResourcesError, UnstableTopologyError):
        t_max = None
    return replace(s, t_max=t_max)


def _runner_and_loop(cfg: SoakConfig, *, proactive: bool, compact, fused_decide: bool,
                     device, dtype, scenarios=None, tick_interval=None, mesh=None):
    from ..api.session import ScenarioRunner
    from ..core import controller as ctl

    scens = [build_scenario(cfg)] if scenarios is None else list(scenarios)
    r = ScenarioRunner(
        scens, tick_interval=cfg.tick_interval if tick_interval is None else tick_interval,
        backend="torch", proactive=proactive or None, compact=compact,
        fused_decide=fused_decide, mesh=mesh, device=device, dtype=dtype,
    )
    loop, n_ticks = ctl.make_fused_loop(
        r.arrays, r.static, r._params(), steps_per_tick=r._steps_per_tick,
        warmup_seconds=scens[0].warmup, proactive=r.proactive_cfg, compact=compact,
        mesh=mesh, device=r.device, dtype=r.dtype,
    )
    return r, loop, n_ticks


def _np_out(out: dict) -> dict:
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in out.items()}


def run_straight(cfg: SoakConfig, *, proactive: bool = False, mesh=None, compact=None,
                 fused_decide: bool = False, device=None, dtype=None, scenarios=None,
                 tick_interval=None, timings: dict | None = None) -> dict:
    """The reference: the whole day in one ``loop(k0)`` call.

    ``fused_decide`` runs the one-pass decide (``kernels/decide_fused``).
    ``scenarios`` / ``tick_interval`` run another static-budget fleet
    through the same harness (``cfg`` then only gives
    ``checkpoint_every``).  ``timings``, a dict, receives the host
    milliseconds of the build (``"rebuild"``) and of the run (``"run"``,
    ending in a device sync).  ``mesh`` (a 1-D
    :class:`~repro_torch.distributed.FleetMesh`) shards the fleet's lanes
    over its ranks (B = 1 pads to one lane per rank); every rank runs this
    call and returns the whole run."""
    t0 = time.perf_counter()
    r, loop, _ = _runner_and_loop(cfg, proactive=proactive, mesh=mesh, compact=compact,
                                  fused_decide=fused_decide, device=device, dtype=dtype,
                                  scenarios=scenarios, tick_interval=tick_interval)
    t1 = time.perf_counter()
    out = loop(r.k)
    if r.device.type == "cuda":
        torch.cuda.synchronize(r.device)
    if timings is not None:
        timings.update(rebuild=[(t1 - t0) * 1e3], run=[(time.perf_counter() - t1) * 1e3])
    return _np_out(out)


def run_checkpointed(cfg: SoakConfig, directory, *, proactive: bool = False, mesh=None,
                     compact=None, fused_decide: bool = False, device=None, dtype=None,
                     scenarios=None, tick_interval=None, timings: dict | None = None) -> dict:
    """The soak: every ``checkpoint_every`` windows, ``save_async`` the
    state, throw the runner and loop away (the simulated crash), restore
    from disk into a freshly built loop, and continue.

    Returns the stitched whole-run output dict -- per-tick stacks
    concatenated across chunks, chunk-local counters summed, carry
    aggregates from the final chunk -- plus ``n_restores``.  ``timings``, a
    dict, receives lists of host milliseconds per chunk under ``"run"``,
    ``"save_async"`` (until it returns), ``"wait"``, ``"rebuild"``,
    ``"restore"`` and ``"save"`` (the final synchronous save).  Under
    ``mesh`` every rank runs this call on one ``directory``: each rank's
    carry holds its own lanes, a save gathers them and the mesh's first
    rank writes the whole fleet's, every rank restores its lanes after the
    save's barrier, and each chunk's outputs are gathered for the report.
    """
    from ..checkpoint.store import CheckpointStore
    from ..core import controller as ctl

    kw = dict(proactive=proactive, mesh=mesh, compact=compact, fused_decide=fused_decide,
              device=device, dtype=dtype, scenarios=scenarios, tick_interval=tick_interval)
    times: dict[str, list] = {k: [] for k in ("run", "save_async", "wait", "rebuild",
                                              "restore", "save")}

    def timed(name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        res = fn(*args, **kwargs)
        if name in ("run", "restore") and r.device.type == "cuda":
            torch.cuda.synchronize(r.device)
        times[name].append((time.perf_counter() - t0) * 1e3)
        return res

    r, loop, n_ticks = _runner_and_loop(cfg, **kw)
    store = CheckpointStore(directory, mesh=mesh)
    state = loop.init(r.k)
    chunks: list[dict] = []
    restores = 0
    while int(state.tick) < n_ticks:
        ticks = min(cfg.checkpoint_every, n_ticks - int(state.tick))
        state, out = timed("run", loop.run, state, ticks)
        chunks.append(_np_out(loop.gather(out)))
        done = int(state.tick)
        if done >= n_ticks:
            timed("save", store.save, done, state)  # nothing left to overlap
            break
        timed("save_async", store.save_async, done, state)
        timed("wait", store.wait)
        # Crash: rebuild everything, restore from disk into a tick-0
        # template (shapes and dtypes only; every leaf is overwritten,
        # the tick counter included).
        del loop, state
        r, loop, _ = timed("rebuild", _runner_and_loop, cfg, **kw)
        restored, _extra = timed("restore", store.restore, loop.init(r.k), step=done)
        state = ctl.ControllerState(*restored)
        restores += 1
    if timings is not None:
        timings.update(times)

    out = {}
    for key in PER_TICK_KEYS + (("mpc_used", "confident") if proactive else ()):
        out[key] = np.concatenate([c[key] for c in chunks], axis=0)
    for key in SUMMED_KEYS:
        out[key] = np.sum([c[key] for c in chunks], axis=0)
    for key in AGGREGATE_KEYS:
        out[key] = chunks[-1][key]
    out["n_restores"] = restores
    return out


def assert_bit_identical(ref: dict, got: dict) -> None:
    """Every shared output equal bit for bit (exact integer and float
    equality, no tolerance); :data:`DIAGNOSTIC_KEYS` are skipped: they
    describe how the run computed, not what it decided."""
    for key in sorted((set(ref) & set(got)) - set(DIAGNOSTIC_KEYS)):
        np.testing.assert_array_equal(
            np.asarray(got[key]), np.asarray(ref[key]), err_msg=key
        )


@dataclass
class SoakReport:
    """Operator-facing trajectories over the day (one scenario, B = 1)."""

    t: np.ndarray  # [ticks] window end times
    k_total: np.ndarray  # [ticks] provisioned processors (the cost curve)
    sojourn: np.ndarray  # [ticks] measured mean sojourn
    miss: np.ndarray  # [ticks] bool: warm window over T_max
    deadline_miss_rate: float
    drop_rate: float
    mean_cost: float  # mean provisioned processors over warm windows
    n_restores: int = 0
    extra: dict = field(default_factory=dict)

    def summary(self) -> dict[str, Any]:
        return {
            "ticks": int(self.t.size),
            "deadline_miss_rate": float(self.deadline_miss_rate),
            "drop_rate": float(self.drop_rate),
            "mean_cost": float(self.mean_cost),
            "peak_cost": float(self.k_total.max(initial=0)),
            "n_restores": int(self.n_restores),
        }


def soak_report(cfg: SoakConfig, out: dict) -> SoakReport:
    s = build_scenario(cfg)
    n_ticks = out["codes"].shape[0]
    t = (np.arange(n_ticks) + 1) * cfg.tick_interval
    warm = (np.arange(n_ticks) * cfg.tick_interval) >= s.warmup
    sojourn = np.asarray(out["sojourn"])[:, 0]
    t_max = np.inf if s.t_max is None else s.t_max
    with np.errstate(invalid="ignore"):
        miss = (sojourn > t_max) & warm
    k_total = np.asarray(out["k"])[:, 0, : s.graph.n].sum(axis=-1)
    offered = float(np.asarray(out["offered"])[0].sum())
    dropped = float(np.asarray(out["dropped"])[0].sum())
    return SoakReport(
        t=t, k_total=k_total, sojourn=sojourn, miss=miss,
        deadline_miss_rate=float(miss.sum() / max(warm.sum(), 1)),
        drop_rate=dropped / max(offered, 1e-300),
        mean_cost=float(k_total[warm].mean()) if warm.any() else float("nan"),
        n_restores=int(out.get("n_restores", 0)),
    )
