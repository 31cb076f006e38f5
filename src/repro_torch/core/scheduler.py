"""DRS scheduler -- the live control loop (paper §III-C steps (a)-(c), §IV),
the port's copy of ``repro/core/scheduler.py``.

Each tick:
  1. pull a smoothed :class:`~repro_torch.core.measurer.MeasurementSnapshot`
     from the measurer;
  2. rebuild the model Topology from (lam0_hat, lam_hat, mu_hat) -- routing
     multiplicities are re-estimated from measured arrival ratios, so a
     shift in the data (more features per frame) is tracked without
     re-declaring the graph;
  3. run Program (6) when a T_max is configured and Program (4) at the
     current K_max;
  4. decide: scale out (``negotiator.ensure``) when Program (6) needs more
     than leased, scale in when it needs much less (hysteresis), and/or
     rebalance when the cost/benefit plan says so;
  5. emit a :class:`SchedulerDecision`.

:class:`DRSScheduler` is a stateful shell over the float64 twin in
:mod:`repro_torch.core.controller` (``overloaded_mask_batch``,
``capped_mask_batch``, ``clamp_row``, ``decide_single``).  The shell owns
what cannot be batched: the measurer, the negotiator lease (the ``ensure``
hook), the cost model and executable cache, the straggler watchdog and the
decision history.

Overload is a defined path: when the measured utilisation
``lam_hat_i / (k_i mu_hat_i)`` reaches 1 (or an operator sheds), the model
is rebuilt from offered-load rates and the action is ``"overloaded"``,
which bypasses the cost/benefit gate and the scale-in hysteresis.
``speed_factors`` scale the effective service rates of heterogeneous
machine classes.  ``proactive=`` (True or an
:class:`~repro_torch.forecast.mpc.MPCConfig`) runs the forecast/MPC plane as
one B = 1 float64 lane of the batched proactive tick: a confident, quiet,
T_max-bound tick commits the plan ahead of the trigger (``"proactive"``).
"""

from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np

from . import controller as ctl
from .jackson import Topology
from .measurer import Measurer, MeasurementSnapshot
from .negotiator import Negotiator
from .rebalance import ExecutableCache, RebalanceCostModel, RebalancePlan

logger = logging.getLogger(__name__)

__all__ = ["SchedulerConfig", "SchedulerDecision", "DRSScheduler", "StragglerDetector"]


@dataclass(frozen=True)
class SchedulerConfig:
    """The scheduler's decision parameters (the fields and defaults of
    ``repro.core.scheduler.SchedulerConfig``)."""

    t_max: float | None = None  # real-time constraint (seconds); None = Program 4 only
    k_max: int | None = None  # static budget; None = ask the negotiator
    horizon_seconds: float = 300.0  # cost/benefit planning horizon
    scale_in_hysteresis: float = 0.8  # scale in only if need < hysteresis * leased
    min_improvement: float = 0.05  # rebalance only if E[T] improves by >= 5%
    headroom: float = 1.1  # provision Program-6 result * headroom (model error guard)
    tick_interval: float = 10.0  # T_m: pull + decide period
    allocator: str = "table"  # Programs (4)/(6) on the gain table, or "heap"
    fused_decide: bool = False  # batched decide through kernels/decide_fused


@dataclass(frozen=True)
class SchedulerDecision:
    """What the stream platform should do after a tick."""

    t: float
    # "none" | "rebalance" | "scale_out" | "scale_in" | "infeasible"
    # | "overloaded" (measured rho >= 1 somewhere: offered-load model,
    #   immediate negotiator scale-out, no hysteresis / cost-benefit gate)
    # | "rebalance_hint" (no model-driven change, but the StragglerDetector
    #   flagged slow instances -- advisory)
    # | "proactive" (the forecast/MPC plane committed an allocation ahead
    #   of any trigger; only with a `proactive=` scheduler)
    action: str
    k_current: np.ndarray  # allocation in force after the tick
    k_target: np.ndarray | None
    k_max: int
    model_sojourn_current: float
    model_sojourn_target: float | None
    measured_sojourn: float
    plan: RebalancePlan | None = None
    reason: str = ""
    # (operator, instance) pairs the straggler watchdog flagged this tick.
    stragglers: tuple = ()

    def as_dict(self) -> dict:
        return {
            "t": self.t,
            "action": self.action,
            "k_current": self.k_current.tolist(),
            "k_target": None if self.k_target is None else self.k_target.tolist(),
            "k_max": self.k_max,
            "model_sojourn_current": self.model_sojourn_current,
            "model_sojourn_target": self.model_sojourn_target,
            "measured_sojourn": self.measured_sojourn,
            "reason": self.reason,
            "stragglers": list(self.stragglers),
        }


class DRSScheduler:
    """The DRS optimizer + scheduler modules glued together (stateful
    shell over the pure controller — see module docstring)."""

    def __init__(
        self,
        operator_names: list[str],
        base_routing: np.ndarray,
        k_current: np.ndarray,
        config: SchedulerConfig,
        *,
        measurer: Measurer | None = None,
        negotiator: Negotiator | None = None,
        cost_model: RebalanceCostModel | None = None,
        executable_cache: ExecutableCache | None = None,
        scaling: list[str] | None = None,
        group_alpha: list[float] | None = None,
        speed_factors: list[float] | None = None,
        on_decision: Callable[[SchedulerDecision], None] | None = None,
        straggler_detector: "StragglerDetector | None" = None,
        proactive=None,
    ):
        self.names = list(operator_names)
        self.base_routing = np.asarray(base_routing, dtype=np.float64)
        self.k_current = np.asarray(k_current, dtype=np.int64).copy()
        self.config = config
        self.measurer = measurer or Measurer(self.names)
        self.negotiator = negotiator
        self.cost_model = cost_model or RebalanceCostModel()
        self.cache = executable_cache
        self.scaling = scaling or ["replica"] * len(self.names)
        self.group_alpha = group_alpha or [0.0] * len(self.names)
        self.speed_factors = (
            None if speed_factors is None
            else np.asarray(speed_factors, dtype=np.float64)
        )
        self.on_decision = on_decision
        self.straggler_detector = (
            StragglerDetector() if straggler_detector is None else straggler_detector
        )
        if config.allocator not in ctl.ALLOCATORS:
            raise ValueError(
                f"unknown allocator {config.allocator!r}; "
                f"expected one of {sorted(ctl.ALLOCATORS)}"
            )
        self._group = np.array([s == "group" for s in self.scaling], dtype=bool)
        self._alpha = np.asarray(self.group_alpha, dtype=np.float64)
        # The forecast/MPC plane: one B = 1 lane of the batched proactive
        # tick; the live path has no backlog probe, so the rollout starts
        # from an empty queue.
        self._proactive = None
        if proactive is not None:
            from ..forecast.mpc import MPCConfig, ProactiveController

            cfg = MPCConfig() if proactive is True else proactive
            self._proactive = ProactiveController.create(
                1, len(self.names), cfg, span=config.tick_interval
            )
        self.history: list[SchedulerDecision] = []
        self.rebalance_count = 0

    # Kept as a class attribute for callers/tests that read the trigger
    # threshold off the scheduler; the value lives with the math now.
    DROP_TRIGGER_FRACTION = ctl.DROP_TRIGGER_FRACTION

    def _mu_eff(self, snap: MeasurementSnapshot) -> np.ndarray:
        if self.speed_factors is None:
            return snap.mu_hat
        return snap.mu_hat * self.speed_factors

    def overloaded_mask(self, snap: MeasurementSnapshot) -> np.ndarray:
        """Per-operator bool: measured offered load >= current capacity,
        OR sustained shedding at the operator's queue (the §11 trigger —
        vectorized in :func:`repro_torch.core.controller.overloaded_mask_batch`)."""
        return ctl.overloaded_mask_batch(
            snap.lam_hat[None],
            self._mu_eff(snap)[None],
            snap.drop_rates()[None],
            self.k_current[None],
            self._group[None],
            self._alpha[None],
        )[0]

    def _capped_mask(self, overloaded: np.ndarray) -> np.ndarray:
        """Operators whose *measured arrival rate* is throughput-capped
        (transitively downstream of a saturated operator)."""
        return ctl.capped_mask_batch(overloaded[None], self.base_routing[None])[0]

    def topology_from(
        self, snap: MeasurementSnapshot, overloaded: np.ndarray | None = None
    ) -> Topology:
        """Rebuild the model from measurements (controller ``clamp_row``;
        see DESIGN.md §4/§11 for the offered-load clamping rules)."""
        n = len(self.names)
        if overloaded is None:
            overloaded = self.overloaded_mask(snap)
        capped = (
            self._capped_mask(overloaded)
            if overloaded.any()
            else np.zeros(n, dtype=bool)
        )
        return ctl.clamp_row(
            self.names,
            self.base_routing,
            snap.lam_hat,
            snap.mu_hat,
            snap.lam0_hat,
            overloaded,
            capped,
            self.scaling,
            self.group_alpha,
            speed=self.speed_factors,
        )

    # ------------------------------------------------------------------ #
    def tick(self, now: float | None = None) -> SchedulerDecision:
        now = time.time() if now is None else now
        snap = self.measurer.pull(now)
        self._observe_instances()
        return self.tick_from(snap, now)

    def tick_from(self, snap: MeasurementSnapshot, now: float) -> SchedulerDecision:
        """One tick on an externally-supplied snapshot (no measurer pull).

        Callers that measure outside the live probe path drive the same
        model/decide path through the controller with it.
        """
        if not snap.complete():
            d = SchedulerDecision(
                now, "none", self.k_current.copy(), None,
                self._k_max(), float("nan"), None, snap.sojourn_hat,
                reason="insufficient measurements",
            )
            self._emit(d)
            return d
        overloaded = self.overloaded_mask(snap)
        if self._proactive is not None:
            d = self._tick_proactive(snap, now, overloaded)
            if d is not None:
                return d
        top = self.topology_from(snap, overloaded)
        return self.decide(top, snap, now, overloaded=overloaded)

    def _tick_proactive(
        self, snap: MeasurementSnapshot, now: float, overloaded: np.ndarray
    ) -> SchedulerDecision | None:
        """One proactive tick: advance the predictors on this (complete)
        snapshot and commit the MPC plan when the confidence gate is open,
        the trigger is quiet and some candidate meets T_max.  ``None``
        falls back to the reactive decide."""
        from ..forecast.mpc import forecast_step, mpc_plan

        pc = self._proactive
        n = len(self.names)
        active = np.ones((1, n), dtype=bool)
        pc.state, lam_pred, conf = forecast_step(
            pc.state, np.asarray(snap.lam_hat, dtype=np.float64)[None], active, pc.cfg,
        )
        pc.confident = conf.copy()
        pc.mpc_used = np.zeros(1, dtype=bool)
        if self.config.t_max is None or overloaded.any() or not conf[0]:
            return None
        in_deg = self.base_routing.sum(axis=0)
        src = in_deg == 0
        if not src.any():
            src[0] = True
        speed = np.ones(n) if self.speed_factors is None else self.speed_factors
        k_max = self._k_max()
        plan_kw = dict(
            mu=np.asarray(snap.mu_hat, dtype=np.float64)[None],
            group=self._group[None], alpha=self._alpha[None],
            speed=np.asarray(speed, dtype=np.float64)[None], active=active,
            src_mask=src[None], cap_queue=pc.cap_queue,
            t_max=np.array([float(self.config.t_max)]), span=pc.span, cfg=pc.cfg,
        )
        q0 = np.zeros((1, n))
        k_cur = self.k_current[None]
        k_hi = int(max(k_max, self.k_current.max(), 1))
        k_plan, any_ok, et_hold, et_plan, need = mpc_plan(
            lam_pred, q0, k_cur, k_max=np.array([k_max]), k_hi=k_hi, **plan_kw
        )
        pc.need = np.asarray(need).copy()
        if self.negotiator is not None:
            tgt = int(need[0])
            if tgt > k_max or tgt < pc.cfg.scale_in_hysteresis * k_max:
                self.negotiator.ensure(max(tgt, 1))
                new_k_max = self._k_max()
                if new_k_max != k_max:
                    k_max = new_k_max
                    k_hi = int(max(k_max, self.k_current.max(), 1))
                    k_plan, any_ok, et_hold, et_plan, need = mpc_plan(
                        lam_pred, q0, k_cur, k_max=np.array([k_max]), k_hi=k_hi, **plan_kw
                    )
                    pc.need = np.asarray(need).copy()
        if not any_ok[0]:
            return None  # no candidate meets T_max: reactive fallback
        pc.mpc_used = np.ones(1, dtype=bool)
        k_new = np.asarray(k_plan[0], dtype=np.int64)
        changed = bool((k_new != self.k_current).any())
        if changed:
            self.k_current = k_new.copy()
            self.rebalance_count += 1
        d = SchedulerDecision(
            now, "proactive" if changed else "none", self.k_current.copy(), k_new, k_max,
            float(et_hold[0]), float(et_plan[0]), snap.sojourn_hat,
            reason="MPC plan committed ahead of trigger" if changed else "proactive hold",
        )
        self._emit(d)
        return d

    def _k_max(self) -> int:
        if self.config.k_max is not None:
            return self.config.k_max
        if self.negotiator is not None:
            return self.negotiator.k_max
        return int(self.k_current.sum())

    # --- Straggler watchdog -------------------------------------------- #
    def _observe_instances(self) -> None:
        """Feed the per-instance service rates the measurer's last pull
        recorded into the straggler watchdog (instance identity = probe
        index within the operator)."""
        if self.straggler_detector is None:
            return
        for op, rates in (getattr(self.measurer, "last_instance_mu", None) or {}).items():
            for idx, mu in enumerate(rates):
                if math.isfinite(mu):
                    self.straggler_detector.observe(op, idx, mu)

    def straggler_hints(self) -> tuple:
        """(operator, instance) pairs currently flagged by the watchdog."""
        if self.straggler_detector is None:
            return ()
        return tuple(self.straggler_detector.stragglers())

    def decide(
        self,
        top: Topology,
        snap: MeasurementSnapshot,
        now: float,
        overloaded: np.ndarray | None = None,
    ) -> SchedulerDecision:
        """One decision on an already-built model: delegates the whole
        flow to the controller's float64 twin (``decide_single``) and
        applies the outcome to the shell state.

        tick() passes the mask it already clamped the topology with, so
        detection and clamping cannot disagree; direct callers get it
        computed here.
        """
        cfg = self.config
        stragglers = self.straggler_hints()
        if overloaded is None:
            overloaded = self.overloaded_mask(snap)

        ensure = None
        if self.negotiator is not None:
            negotiator = self.negotiator

            def ensure(target: int) -> int:
                negotiator.ensure(target)
                return negotiator.k_max

        row = ctl.decide_single(
            top,
            self.k_current,
            self._k_max(),
            t_max=cfg.t_max,
            headroom=cfg.headroom,
            scale_in_hysteresis=cfg.scale_in_hysteresis,
            min_improvement=cfg.min_improvement,
            horizon_seconds=cfg.horizon_seconds,
            allocator=cfg.allocator,
            overloaded=overloaded,
            ensure=ensure,
            cost_model=self.cost_model,
            cache=self.cache,
            stage_names=self.names,
            stragglers=stragglers,
            names=self.names,
        )
        if row.applied:
            self.k_current = row.k_next.copy()
            self.rebalance_count += 1
        d = SchedulerDecision(
            now,
            row.action,
            self.k_current.copy(),
            row.k_target,
            self._k_max() if row.applied else row.k_max,
            row.et_cur,
            row.et_target,
            snap.sojourn_hat,
            row.plan,
            row.reason,
            stragglers if row.action in ("none", "rebalance_hint") else (),
        )
        self._emit(d)
        return d

    def _emit(self, d: SchedulerDecision) -> None:
        self.history.append(d)
        logger.debug("DRS decision: %s", d.as_dict())
        if self.on_decision:
            self.on_decision(d)


class StragglerDetector:
    """Flags slow instances: per-instance mu more than ``factor`` below the
    operator median over the last window of pulls."""

    def __init__(self, factor: float = 2.0, window: int = 3):
        self.factor = factor
        self.window = window
        self._hist: dict[tuple[str, int], list[float]] = {}

    def observe(self, operator: str, instance: int, mu_hat: float) -> None:
        hist = self._hist.setdefault((operator, instance), [])
        hist.append(mu_hat)
        # Only the last `window` samples are ever read; trim so a control
        # loop ticking for months doesn't grow the history unboundedly.
        if len(hist) > self.window:
            del hist[: -self.window]

    def stragglers(self) -> list[tuple[str, int]]:
        by_op: dict[str, list[tuple[int, float]]] = {}
        for (op, inst), hist in self._hist.items():
            recent = [h for h in hist[-self.window :] if math.isfinite(h)]
            if recent:
                by_op.setdefault(op, []).append((inst, float(np.mean(recent))))
        out = []
        for op, pairs in by_op.items():
            if len(pairs) < 2:
                continue
            med = float(np.median([m for _, m in pairs]))
            for inst, m in pairs:
                if m * self.factor < med:
                    out.append((op, inst))
        return out
