"""Discrete-event simulator for operator networks (model validation), the
port's copy of ``repro/streaming/des.py``.

It models what the stream platform does, tuple by tuple, in simulated time:

* external tuples arrive at source operators through an
  :class:`ArrivalProcess` (exponential, uniform on [0, 2/rate],
  deterministic, a 2-state Markov-modulated Poisson ``"mmpp"``, or a
  flash-crowd ``"burst"`` schedule);
* each operator has one FIFO queue and ``k_i`` parallel servers drawing
  service times from a :class:`ServiceProcess` (exponential,
  deterministic, uniform or lognormal);
* queues may be bounded (``SimConfig.queue_capacity``) under the live
  engine's :class:`~repro_torch.streaming.overload.OverloadPolicy` (block
  through a pending line, shed-newest, shed-oldest), with per-operator
  drop accounting; a shed external tuple is not counted as an external
  arrival, so ``lam0_hat`` stays unbiased;
* a completion at operator *i* spawns tuples downstream per the routing
  matrix (the integer part, plus one with the fractional part's
  probability), and a per-root outstanding count gives the paper's
  complete sojourn (arrival until the whole processing tree drained);
* optional per-hop network delay; ``rebalance_at(t, k_new, pause)``
  changes the allocation mid-run with a processing pause; a
  :class:`~repro_torch.core.measurer.Measurer` can be attached so the
  measure -> model -> reallocate loop runs in simulated time.

Host code by nature: numpy and ``heapq``, with one ``np.random.Generator``
seeded from ``SimConfig.seed`` and drawn in the reference's order, so the
same seeds give the same event traces in both packages.
"""

from __future__ import annotations

import heapq
import itertools
import math
from collections import deque
from dataclasses import dataclass, field, replace

import numpy as np

from ..core.jackson import Topology
from ..core.measurer import Measurer
from .overload import OverloadPolicy

__all__ = ["ArrivalProcess", "ServiceProcess", "SimConfig", "SimResult", "NetworkSimulator",
           "simulate_allocation"]


@dataclass(frozen=True)
class ArrivalProcess:
    """Inter-arrival time generator for a source operator.

    Kinds:

    * ``exponential`` / ``uniform`` / ``deterministic`` — renewal processes
      at mean rate ``rate``;
    * ``mmpp`` — 2-state Markov-modulated Poisson process: Poisson at
      ``rate`` in state 0 and ``rate2`` in state 1, switching at
      exponential rates ``switch01`` (0→1) and ``switch10`` (1→0).  The
      long-run mean rate is ``(switch10*rate + switch01*rate2) /
      (switch01 + switch10)``;
    * ``burst`` — deterministic flash-crowd schedule: Poisson at ``rate``
      except during the first ``burst_length`` seconds of every
      ``burst_every``-second cycle, where the rate is ``rate2`` (the
      Fig. 9/10-style mid-run workload shift, repeatable).

    ``mmpp`` and ``burst`` carry private mutable phase state, so one
    instance must not be shared between concurrently-running simulators.
    """

    rate: float
    kind: str = "exponential"  # exponential | uniform | deterministic | mmpp | burst
    # mmpp state-1 rate / burst peak rate.  Required for those kinds (an
    # explicit 0.0 models an ON/OFF process; None would be a silent
    # degenerate config, so it raises instead).
    rate2: float | None = None
    switch01: float = 0.1  # mmpp: 0 -> 1 transition rate (per second)
    switch10: float = 0.1  # mmpp: 1 -> 0 transition rate (per second)
    burst_every: float = 60.0  # burst: cycle period (seconds)
    burst_length: float = 5.0  # burst: peak-rate window at each cycle start
    _state: dict = field(default_factory=dict, repr=False, compare=False)

    def sample(self, rng: np.random.Generator) -> float:
        if self.kind == "mmpp":
            return self._sample_mmpp(rng)
        if self.kind == "burst":
            return self._sample_burst(rng)
        if self.rate <= 0:
            return math.inf
        mean = 1.0 / self.rate
        if self.kind == "exponential":
            return rng.exponential(mean)
        if self.kind == "uniform":
            # uniform on [0, 2*mean] — mean preserved, like the paper's fps
            return rng.uniform(0.0, 2.0 * mean)
        if self.kind == "deterministic":
            return mean
        raise ValueError(f"unknown arrival kind {self.kind!r}")

    def _rate2(self) -> float:
        if self.rate2 is None:
            raise ValueError(
                f"ArrivalProcess(kind={self.kind!r}) needs rate2= (second-state"
                " / peak rate); pass 0.0 explicitly for an ON/OFF process"
            )
        return self.rate2

    def _sample_mmpp(self, rng: np.random.Generator) -> float:
        """Competing exponentials: in each modulating state the next event
        is either an arrival or a state switch, whichever fires first."""
        rate2 = self._rate2()
        state = self._state.setdefault("s", 0)
        t = 0.0
        while True:
            r = self.rate if state == 0 else rate2
            sw = self.switch01 if state == 0 else self.switch10
            t_arr = rng.exponential(1.0 / r) if r > 0 else math.inf
            t_sw = rng.exponential(1.0 / sw) if sw > 0 else math.inf
            if not math.isfinite(t_arr) and not math.isfinite(t_sw):
                return math.inf
            if t_arr <= t_sw:
                self._state["s"] = state
                return t + t_arr
            t += t_sw
            state = 1 - state

    def _sample_burst(self, rng: np.random.Generator) -> float:
        """Piecewise-constant-rate Poisson: draw within the current phase,
        restarting from the boundary when the draw crosses it."""
        rate2 = self._rate2()
        if self.burst_every <= 0 or not 0 < self.burst_length <= self.burst_every:
            raise ValueError(
                f"burst needs 0 < burst_length <= burst_every, got "
                f"length={self.burst_length}, every={self.burst_every}"
            )
        if self.rate <= 0 and rate2 <= 0:
            return math.inf
        t = self._state.get("t", 0.0)
        t0 = t
        while True:
            phase = t % self.burst_every
            in_burst = phase < self.burst_length
            r = rate2 if in_burst else self.rate
            boundary = t - phase + (self.burst_length if in_burst else self.burst_every)
            if r <= 0:
                t = boundary
                continue
            dt = rng.exponential(1.0 / r)
            if t + dt <= boundary:
                self._state["t"] = t + dt
                return t + dt - t0
            t = boundary


@dataclass(frozen=True)
class ServiceProcess:
    """Service-time generator for an operator's servers."""

    rate: float
    kind: str = "exponential"  # exponential | uniform | deterministic | lognormal
    cv: float = 1.0  # coefficient of variation for lognormal

    def sample(self, rng: np.random.Generator) -> float:
        mean = 1.0 / self.rate
        if self.kind == "exponential":
            return rng.exponential(mean)
        if self.kind == "uniform":
            return rng.uniform(0.0, 2.0 * mean)
        if self.kind == "deterministic":
            return mean
        if self.kind == "lognormal":
            sigma2 = math.log(1.0 + self.cv**2)
            mu = math.log(mean) - sigma2 / 2.0
            return rng.lognormal(mu, math.sqrt(sigma2))
        raise ValueError(f"unknown service kind {self.kind!r}")


@dataclass
class SimConfig:
    seed: int = 0
    warmup: float = 10.0  # ignore completions before this time
    horizon: float = 120.0
    network_delay: float = 0.0  # fixed per-hop delay (out-of-model cost, Fig. 8)
    max_events: int = 5_000_000
    queue_capacity: int | None = None  # None = unbounded
    # What to do when a bounded queue is full (DESIGN.md §11).  The default
    # matches the historical DES behaviour (arriving tuple is dropped).
    overload_policy: OverloadPolicy | str = "shed-newest"


@dataclass
class SimResult:
    completed: int
    mean_sojourn: float  # complete sojourn (tree completion) — what the paper measures
    std_sojourn: float
    mean_visit_sum: float  # sum of per-visit sojourns (what Eq. 3 predicts exactly)
    p95_sojourn: float
    per_op_arrival_rate: np.ndarray  # post-warmup offered arrivals / post-warmup span
    per_op_mean_service: np.ndarray
    per_op_mean_wait: np.ndarray
    dropped: int  # total tuples shed (whole run, all operators)
    sojourn_series: list[tuple[float, float]] = field(default_factory=list)
    # Overload accounting (zeros when queues are unbounded):
    per_op_dropped: np.ndarray | None = None  # tuples shed per operator (whole run)
    per_op_drop_rate: np.ndarray | None = None  # post-warmup sheds / span (tuples/s)
    per_op_max_backlog: np.ndarray | None = None  # max queue + blocked-pending length
    shed_roots: int = 0  # external tuples whose tree lost >= 1 tuple

    def as_dict(self) -> dict:
        return {
            "completed": self.completed,
            "mean_sojourn": self.mean_sojourn,
            "std_sojourn": self.std_sojourn,
            "mean_visit_sum": self.mean_visit_sum,
            "p95_sojourn": self.p95_sojourn,
            "per_op_arrival_rate": self.per_op_arrival_rate.tolist(),
            "dropped": self.dropped,
            "per_op_dropped": None
            if self.per_op_dropped is None
            else self.per_op_dropped.tolist(),
            "per_op_drop_rate": None
            if self.per_op_drop_rate is None
            else self.per_op_drop_rate.tolist(),
            "per_op_max_backlog": None
            if self.per_op_max_backlog is None
            else self.per_op_max_backlog.tolist(),
            "shed_roots": self.shed_roots,
        }


# Event kinds (ordering tiebreaker: sequence number)
_ARRIVAL, _SERVICE_DONE, _CONTROL = 0, 1, 2


@dataclass
class _Root:
    t_arrival: float
    outstanding: int = 0
    visit_time_sum: float = 0.0
    shed: bool = False  # any tuple of this root's tree was dropped


class NetworkSimulator:
    """Event-driven simulation of an operator network under allocation k."""

    def __init__(
        self,
        topology: Topology,
        k: np.ndarray | list[int],
        *,
        config: SimConfig | None = None,
        arrivals: list[ArrivalProcess] | None = None,
        services: list[ServiceProcess] | None = None,
        measurer: Measurer | None = None,
    ):
        self.top = topology
        self.cfg = config or SimConfig()
        self.k = np.asarray(k, dtype=np.int64).copy()
        n = topology.n
        self.arrivals = arrivals or [
            ArrivalProcess(rate=float(topology.lam0[i])) for i in range(n)
        ]
        self.services = services or [
            ServiceProcess(rate=op.mu) for op in topology.operators
        ]
        self.measurer = measurer
        self._probes = (
            [measurer.new_probe(op.name) for op in topology.operators]
            if measurer is not None
            else None
        )
        if self.cfg.queue_capacity is not None and self.cfg.queue_capacity < 1:
            raise ValueError(
                f"queue_capacity must be >= 1 or None (unbounded), got "
                f"{self.cfg.queue_capacity}"
            )
        self.policy = OverloadPolicy.coerce(self.cfg.overload_policy)
        self.rng = np.random.default_rng(self.cfg.seed)
        self._seq = itertools.count()
        self._events: list[tuple[float, int, int, tuple]] = []
        self._queues: list[deque[tuple[float, int]]] = [deque() for _ in range(n)]
        # Block policy: arrivals that found the queue full wait here (the
        # DES analogue of a blocked producer) and are admitted FIFO.
        self._pending: list[deque[tuple[float, int]]] = [deque() for _ in range(n)]
        self._busy = np.zeros(n, dtype=np.int64)
        self._paused_until = 0.0
        self._roots: dict[int, _Root] = {}
        self._root_ids = itertools.count()
        self._sojourns: list[float] = []
        self._visit_sums: list[float] = []
        self._series: list[tuple[float, float]] = []
        self._op_arrivals = np.zeros(n, dtype=np.int64)
        self._op_arrivals_warm = np.zeros(n, dtype=np.int64)  # post-warmup only
        self._op_service_sum = np.zeros(n)
        self._op_service_n = np.zeros(n, dtype=np.int64)
        self._op_wait_sum = np.zeros(n)
        self._op_wait_n = np.zeros(n, dtype=np.int64)
        self._dropped = 0
        self._op_drops = np.zeros(n, dtype=np.int64)
        self._op_drops_warm = np.zeros(n, dtype=np.int64)
        self._op_max_backlog = np.zeros(n, dtype=np.int64)
        self._shed_roots = 0
        self._rebalances: list[tuple[float, np.ndarray, float]] = []
        self.now = 0.0

    # ------------------------------------------------------------------ #
    def rebalance_at(self, t: float, k_new: np.ndarray | list[int], pause: float = 0.0) -> None:
        """Schedule an allocation change (with optional processing pause)."""
        self._push(t, _CONTROL, ("rebalance", np.asarray(k_new, dtype=np.int64), pause))

    def schedule_rate_change(self, t: float, op_index: int, new_rate: float, kind: str | None = None) -> None:
        """Change an operator's service rate mid-run (workload shift / straggler)."""
        self._push(t, _CONTROL, ("mu", op_index, new_rate, kind))

    def schedule_arrival_change(self, t: float, op_index: int, new_rate: float) -> None:
        self._push(t, _CONTROL, ("lam0", op_index, new_rate))

    def _push(self, t: float, kind: int, payload: tuple) -> None:
        heapq.heappush(self._events, (t, kind, next(self._seq), payload))

    # ------------------------------------------------------------------ #
    def _spawn_external(self, i: int) -> None:
        dt = self.arrivals[i].sample(self.rng)
        if math.isfinite(dt):
            self._push(self.now + dt, _ARRIVAL, ("external", i))

    def _admit(self, i: int, root_id: int) -> bool:
        """Tuple arrives at operator i's queue tail.

        Returns True when the tuple joined the system (queue or blocked
        pending line), False when it was shed under the overload policy.
        The queue-tail probe counts it either way (offered load, paper
        Appendix C); drops are recorded separately.
        """
        self._op_arrivals[i] += 1
        if self.now >= self.cfg.warmup:
            self._op_arrivals_warm[i] += 1
        if self._probes is not None:
            self._probes[i].on_enqueue()
        cap = self.cfg.queue_capacity
        q = self._queues[i]
        if cap is not None and (len(q) >= cap or self._pending[i]):
            if self.policy.kind == "shed-newest":
                # Rejected tuple never joins the tree.
                self._record_drop(i)
                self._poison_root(root_id)
                return False
            if self.policy.kind == "shed-oldest":
                _t_old, old_root = q.popleft()
                self._record_drop(i)
                self._drop_queued(old_root)
                # fall through: the new tuple takes the freed slot
            else:  # block: wait at the tail (FIFO behind earlier blocked)
                self._roots[root_id].outstanding += 1
                self._pending[i].append((self.now, root_id))
                self._note_backlog(i)
                return True
        self._roots[root_id].outstanding += 1
        q.append((self.now, root_id))
        self._note_backlog(i)
        self._try_start(i)
        return True

    def _note_backlog(self, i: int) -> None:
        backlog = len(self._queues[i]) + len(self._pending[i])
        if backlog > self._op_max_backlog[i]:
            self._op_max_backlog[i] = backlog

    def _record_drop(self, i: int) -> None:
        self._dropped += 1
        self._op_drops[i] += 1
        if self.now >= self.cfg.warmup:
            self._op_drops_warm[i] += 1
        if self._probes is not None:
            self._probes[i].on_dropped()

    def _poison_root(self, root_id: int) -> None:
        """A tuple of this root was shed before joining a queue."""
        root = self._roots[root_id]
        root.shed = True
        if root.outstanding == 0:
            self._retire_root(root_id)

    def _drop_queued(self, root_id: int) -> None:
        """A queued tuple of this root was evicted (shed-oldest)."""
        root = self._roots[root_id]
        root.shed = True
        root.outstanding -= 1
        if root.outstanding == 0:
            self._retire_root(root_id)

    def _promote_pending(self, i: int) -> None:
        cap = self.cfg.queue_capacity
        q, pend = self._queues[i], self._pending[i]
        while pend and (cap is None or len(q) < cap):
            q.append(pend.popleft())

    def _try_start(self, i: int) -> None:
        if self.now < self._paused_until:
            return
        q = self._queues[i]
        self._promote_pending(i)
        while self._busy[i] < self.k[i] and q:
            t_enq, root_id = q.popleft()
            self._promote_pending(i)  # a slot freed: unblock a producer
            wait = self.now - t_enq
            self._op_wait_sum[i] += wait
            self._op_wait_n[i] += 1
            st = self.services[i].sample(self.rng)
            self._op_service_sum[i] += st
            self._op_service_n[i] += 1
            if self._probes is not None:
                self._probes[i].on_processed(st)
            self._busy[i] += 1
            root = self._roots[root_id]
            root.visit_time_sum += wait + st
            self._push(self.now + st, _SERVICE_DONE, (i, root_id))

    def _retire_root(self, root_id: int) -> None:
        """Outstanding count hit zero: record completion or shed."""
        root = self._roots.pop(root_id)
        if root.shed:
            # Partially-processed tree: its sojourn would be biased (the
            # shed branches never ran), so it is counted, not timed.
            self._shed_roots += 1
            return
        sojourn = self.now - root.t_arrival
        if self.now >= self.cfg.warmup:
            self._sojourns.append(sojourn)
            self._visit_sums.append(root.visit_time_sum)
            self._series.append((self.now, sojourn))
        if self.measurer is not None:
            self.measurer.on_tuple_complete(sojourn)

    def _finish_derived(self, root_id: int) -> None:
        root = self._roots[root_id]
        root.outstanding -= 1
        if root.outstanding == 0:
            self._retire_root(root_id)

    def _route_downstream(self, i: int, root_id: int) -> None:
        routing = self.top.routing
        root = self._roots[root_id]
        spawned = 0
        for j in range(self.top.n):
            w = routing[i][j]
            if w <= 0:
                continue
            count = int(w) + (1 if self.rng.random() < (w - int(w)) else 0)
            for _ in range(count):
                spawned += 1
                delay = self.cfg.network_delay
                if delay > 0:
                    root.outstanding += 1  # in-flight on the wire
                    self._push(self.now + delay, _ARRIVAL, ("hop", j, root_id))
                else:
                    self._admit(j, root_id)
        # No children and nothing outstanding is handled by _finish_derived.

    # ------------------------------------------------------------------ #
    def run(self) -> SimResult:
        cfg = self.cfg
        for i in range(self.top.n):
            if self.top.lam0[i] > 0:
                self._spawn_external(i)
        events = 0
        while self._events and events < cfg.max_events:
            t, kind, _, payload = heapq.heappop(self._events)
            if t > cfg.horizon:
                break
            self.now = t
            events += 1
            if kind == _ARRIVAL:
                if payload[0] == "external":
                    i = payload[1]
                    root_id = next(self._root_ids)
                    self._roots[root_id] = _Root(t_arrival=self.now)
                    admitted = self._admit(i, root_id)
                    # Only admitted tuples count toward lam0_hat; a tuple
                    # shed at the source is visible via the drop counters
                    # instead (otherwise lam0_hat is biased upward and the
                    # model predicts load the network never carries).
                    if admitted and self.measurer is not None:
                        self.measurer.on_external_arrival()
                    self._spawn_external(i)
                else:  # network hop delivery
                    _, j, root_id = payload
                    self._admit(j, root_id)
                    self._finish_derived(root_id)  # wire leg done
            elif kind == _SERVICE_DONE:
                i, root_id = payload
                self._busy[i] -= 1
                self._route_downstream(i, root_id)
                self._finish_derived(root_id)
                self._try_start(i)
            else:  # _CONTROL
                if payload[0] == "rebalance":
                    _, k_new, pause = payload
                    self.k = k_new.copy()
                    self._rebalances.append((self.now, k_new.copy(), pause))
                    if pause > 0:
                        self._paused_until = self.now + pause
                        self._push(self._paused_until, _CONTROL, ("resume",))
                    else:
                        for i in range(self.top.n):
                            self._try_start(i)
                elif payload[0] == "resume":
                    for i in range(self.top.n):
                        self._try_start(i)
                elif payload[0] == "mu":
                    _, i, rate, svc_kind = payload
                    old = self.services[i]
                    self.services[i] = ServiceProcess(rate, svc_kind or old.kind, old.cv)
                elif payload[0] == "lam0":
                    _, i, rate = payload
                    old = self.arrivals[i]
                    had = old.rate > 0 or (old.rate2 or 0.0) > 0
                    # replace() keeps kind AND the mmpp/burst parameters
                    # (rate2, switch rates, burst schedule, phase state).
                    self.arrivals[i] = replace(old, rate=rate)
                    if not had and rate > 0:
                        self._spawn_external(i)
        # Post-warmup counts over the post-warmup span: warmup arrivals
        # must not leak into the steady-state rate estimate.
        measured_span = max(self.now - cfg.warmup, 1e-9)
        soj = np.asarray(self._sojourns) if self._sojourns else np.array([np.nan])
        vs = np.asarray(self._visit_sums) if self._visit_sums else np.array([np.nan])
        return SimResult(
            completed=len(self._sojourns),
            mean_sojourn=float(np.mean(soj)),
            std_sojourn=float(np.std(soj)),
            mean_visit_sum=float(np.mean(vs)),
            p95_sojourn=float(np.percentile(soj, 95)),
            per_op_arrival_rate=self._op_arrivals_warm / measured_span,
            per_op_mean_service=np.where(
                self._op_service_n > 0, self._op_service_sum / np.maximum(self._op_service_n, 1), np.nan
            ),
            per_op_mean_wait=np.where(
                self._op_wait_n > 0, self._op_wait_sum / np.maximum(self._op_wait_n, 1), np.nan
            ),
            dropped=self._dropped,
            sojourn_series=self._series,
            per_op_dropped=self._op_drops.copy(),
            per_op_drop_rate=self._op_drops_warm / measured_span,
            per_op_max_backlog=self._op_max_backlog.copy(),
            shed_roots=self._shed_roots,
        )


def simulate_allocation(
    topology: Topology,
    k: np.ndarray | list[int],
    *,
    seed: int = 0,
    horizon: float = 120.0,
    warmup: float = 10.0,
    network_delay: float = 0.0,
    arrival_kind: str = "exponential",
    service_kind: str = "exponential",
    queue_capacity: int | None = None,
    overload_policy: OverloadPolicy | str = "shed-newest",
) -> SimResult:
    """One-call helper: simulate topology under allocation k."""
    n = topology.n
    arrivals = [
        ArrivalProcess(rate=float(topology.lam0[i]), kind=arrival_kind) for i in range(n)
    ]
    services = [ServiceProcess(rate=op.mu, kind=service_kind) for op in topology.operators]
    sim = NetworkSimulator(
        topology,
        k,
        config=SimConfig(
            seed=seed,
            horizon=horizon,
            warmup=warmup,
            network_delay=network_delay,
            queue_capacity=queue_capacity,
            overload_policy=overload_policy,
        ),
        arrivals=arrivals,
        services=services,
    )
    return sim.run()
