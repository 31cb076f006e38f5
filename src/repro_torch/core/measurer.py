"""DRS measurer (paper §IV + Appendix B-A), the live path's copy of
``repro/core/measurer.py``.

Per operator it estimates the aggregate tuple arrival rate ``lam_hat_i``
and the per-processor service rate ``mu_hat_i``; globally the external
arrival rate ``lam0_hat`` and the measured mean complete sojourn time.

* **bi-layer sampling** -- each operator instance times one tuple every
  ``N_m`` local inputs (:class:`InstanceProbe`); the central
  :class:`Measurer` pulls and resets the instance counters every ``T_m``;
* **operator-level aggregation** -- instance counters are summed per
  operator before the model sees them;
* **smoothing** -- alpha-weighted EWMA or window averaging.

Arrivals are counted at the queue *tail* (Appendix C), so an overloaded
operator still reports its offered load; shed tuples are reported through
:meth:`InstanceProbe.on_dropped` and surface as ``drop_hat``.
:class:`MeasurementBatch` stacks ``[B, N]`` snapshots, the batched
controller's input (``tick_batch``); :func:`stack_snapshots` builds one
from per-tenant snapshots (the fleet session's).  Numpy and thread code only.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "Smoother",
    "EwmaSmoother",
    "WindowSmoother",
    "InstanceProbe",
    "OperatorMetrics",
    "Measurer",
    "MeasurementSnapshot",
    "MeasurementBatch",
    "stack_snapshots",
]


class Smoother:
    def update(self, x: float) -> float:  # pragma: no cover - interface
        raise NotImplementedError

    @property
    def value(self) -> float:  # pragma: no cover - interface
        raise NotImplementedError


class EwmaSmoother(Smoother):
    """D(n) = alpha * D(n-1) + (1 - alpha) * d(n), alpha in [0, 1)."""

    def __init__(self, alpha: float = 0.6):
        if not 0.0 <= alpha < 1.0:
            raise ValueError(f"alpha must be in [0,1), got {alpha}")
        self.alpha = alpha
        self._v: float | None = None

    def update(self, x: float) -> float:
        self._v = x if self._v is None else self.alpha * self._v + (1 - self.alpha) * x
        return self._v

    @property
    def value(self) -> float:
        return float("nan") if self._v is None else self._v


class WindowSmoother(Smoother):
    """D(n) = (1/w) * sum_{j=n-w+1..n} d(j)."""

    def __init__(self, w: int = 5):
        if w < 1:
            raise ValueError(f"window must be >= 1, got {w}")
        self._buf: deque[float] = deque(maxlen=w)

    def update(self, x: float) -> float:
        self._buf.append(x)
        return self.value

    @property
    def value(self) -> float:
        return float(np.mean(self._buf)) if self._buf else float("nan")


def make_smoother(kind: str, **kw) -> Smoother:
    if kind == "ewma":
        return EwmaSmoother(**kw)
    if kind == "window":
        return WindowSmoother(**kw)
    raise ValueError(f"unknown smoother kind {kind!r}")


@dataclass
class InstanceProbe:
    """Instance-local metric recorder (the injected 'measurement logic').

    Thread-safe; records every ``n_m``-th tuple's service time and counts
    every enqueue (arrivals are never sampled — counting is cheap; only the
    *timing* is sampled, mirroring the paper's overhead argument).
    """

    n_m: int = 10
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    arrivals: int = 0
    processed: int = 0
    dropped: int = 0
    sampled_service_time: float = 0.0
    sampled_count: int = 0
    _tick: int = 0

    def on_enqueue(self, n: int = 1) -> None:
        with self._lock:
            self.arrivals += n

    def on_dropped(self, n: int = 1) -> None:
        """Tuple(s) shed at this operator's queue (still counted as offered
        load by :meth:`on_enqueue`; this records the shed portion)."""
        with self._lock:
            self.dropped += n

    def on_processed(self, service_time: float, n: int = 1) -> None:
        with self._lock:
            self.processed += n
            self._tick += n
            # Subtract (not reset) so batched reports (n > 1) crossing the
            # n_m boundary keep the remainder and the sampling rate stays
            # exactly 1/N_m; each wrap is one sampled tuple.
            while self._tick >= self.n_m:
                self._tick -= self.n_m
                self.sampled_service_time += service_time
                self.sampled_count += 1

    def drain(self) -> tuple[int, int, float, int, int]:
        """Pull-and-reset (the central measurer's T_m pull)."""
        with self._lock:
            out = (
                self.arrivals,
                self.processed,
                self.sampled_service_time,
                self.sampled_count,
                self.dropped,
            )
            self.arrivals = 0
            self.processed = 0
            self.sampled_service_time = 0.0
            self.sampled_count = 0
            self.dropped = 0
            return out


@dataclass
class OperatorMetrics:
    """Operator-level aggregated + smoothed estimates."""

    name: str
    lam_smoother: Smoother
    mu_smoother: Smoother
    drop_smoother: Smoother
    lam_hat: float = float("nan")
    mu_hat: float = float("nan")
    drop_hat: float = 0.0
    last_raw_lam: float = float("nan")
    last_raw_mu: float = float("nan")

    def ingest(
        self,
        arrivals: int,
        service_time_sum: float,
        samples: int,
        dt: float,
        dropped: int = 0,
    ) -> None:
        if dt <= 0:
            return
        raw_lam = arrivals / dt
        self.last_raw_lam = raw_lam
        self.lam_hat = self.lam_smoother.update(raw_lam)
        self.drop_hat = self.drop_smoother.update(dropped / dt)
        if samples > 0 and service_time_sum > 0:
            raw_mu = samples / service_time_sum  # tuples/sec per processor
            self.last_raw_mu = raw_mu
            self.mu_hat = self.mu_smoother.update(raw_mu)


@dataclass(frozen=True)
class MeasurementSnapshot:
    """One pull interval's smoothed view — the optimizer's input."""

    lam_hat: np.ndarray  # per-operator smoothed *offered* arrival rates (queue tail)
    mu_hat: np.ndarray  # per-operator smoothed per-processor service rates
    lam0_hat: float  # external arrival rate (admitted tuples only)
    sojourn_hat: float  # measured mean complete sojourn time E[T^]
    t: float  # timestamp of the pull
    # Per-operator smoothed drop (load-shed) rates, tuples/sec; zeros when
    # nothing was shed.  lam_hat - drop_hat is the admitted rate.
    drop_hat: np.ndarray | None = None

    def complete(self) -> bool:
        return (
            np.all(np.isfinite(self.lam_hat))
            and np.all(np.isfinite(self.mu_hat))
            and np.isfinite(self.lam0_hat)
        )

    def drop_rates(self) -> np.ndarray:
        """Per-operator drop rates (zeros when none were recorded)."""
        if self.drop_hat is None:
            return np.zeros_like(self.lam_hat)
        return np.nan_to_num(self.drop_hat, nan=0.0)

    @classmethod
    def from_rates(
        cls,
        lam_hat,
        mu_hat,
        lam0_hat: float,
        sojourn_hat: float,
        t: float,
        drop_hat=None,
    ) -> "MeasurementSnapshot":
        """Snapshot from already-aggregated rates (feeds
        ``DRSScheduler.tick_from`` without the probe/pull layer)."""
        return cls(
            lam_hat=np.asarray(lam_hat, dtype=np.float64),
            mu_hat=np.asarray(mu_hat, dtype=np.float64),
            lam0_hat=float(lam0_hat),
            sojourn_hat=float(sojourn_hat),
            t=float(t),
            drop_hat=None if drop_hat is None else np.asarray(drop_hat, dtype=np.float64),
        )



@dataclass(frozen=True)
class MeasurementBatch:
    """A ``[B, N]`` stack of measurement snapshots: the batched controller's
    input surface.  Scenarios narrower than ``N`` are padded with inert
    lanes (zero rates, finite mu); the controller's ``active`` masks
    recover the real lanes."""

    lam_hat: np.ndarray  # [B, N] smoothed offered arrival rates
    mu_hat: np.ndarray  # [B, N] per-processor service rates (reference class)
    lam0_hat: np.ndarray  # [B] external (admitted) arrival rates
    sojourn_hat: np.ndarray  # [B] measured mean sojourn E[T^]
    t: float  # timestamp shared by the stack
    drop_hat: np.ndarray  # [B, N] smoothed shed rates (zeros when none)

    def complete(self, active: np.ndarray | None = None) -> np.ndarray:
        """[B] bool: every *active* lane finite (the per-snapshot
        ``complete()`` rule, vectorized)."""
        fin = np.isfinite(self.lam_hat) & np.isfinite(self.mu_hat)
        if active is not None:
            fin = fin | ~np.asarray(active, dtype=bool)
        return fin.all(axis=1) & np.isfinite(self.lam0_hat)

    @classmethod
    def from_rates(cls, lam_hat, mu_hat, lam0_hat, sojourn_hat, t: float,
                   drop_hat=None) -> "MeasurementBatch":
        lam_hat = np.atleast_2d(np.asarray(lam_hat, dtype=np.float64))
        return cls(
            lam_hat=lam_hat,
            mu_hat=np.atleast_2d(np.asarray(mu_hat, dtype=np.float64)),
            lam0_hat=np.atleast_1d(np.asarray(lam0_hat, dtype=np.float64)),
            sojourn_hat=np.atleast_1d(np.asarray(sojourn_hat, dtype=np.float64)),
            t=float(t),
            drop_hat=(np.zeros_like(lam_hat) if drop_hat is None
                      else np.atleast_2d(np.asarray(drop_hat, dtype=np.float64))),
        )


def stack_snapshots(
    snaps: "list[MeasurementSnapshot]", n: int | None = None
) -> MeasurementBatch:
    """Stack per-scenario / per-tenant snapshots into one padded batch.

    Padding lanes get zero arrival and drop rates and ``mu = 1`` (finite,
    so they never fail the completeness check); ``n`` widens the batch
    beyond the widest snapshot when the caller's static arrays demand it.
    """
    if not snaps:
        raise ValueError("need at least one snapshot to stack")
    width = max(len(s.lam_hat) for s in snaps)
    n = width if n is None else max(n, width)
    b = len(snaps)
    lam = np.zeros((b, n))
    mu = np.ones((b, n))
    drop = np.zeros((b, n))
    lam0 = np.zeros(b)
    soj = np.zeros(b)
    for bi, s in enumerate(snaps):
        ni = len(s.lam_hat)
        lam[bi, :ni] = s.lam_hat
        mu[bi, :ni] = s.mu_hat
        drop[bi, :ni] = s.drop_rates()
        lam0[bi] = s.lam0_hat
        soj[bi] = s.sojourn_hat
    return MeasurementBatch(lam, mu, lam0, soj, float(snaps[0].t), drop)


class Measurer:
    """Central measurer: owns per-operator probes + global tuple tracking.

    The engine (streaming/engine.py) registers one probe per operator
    instance; completed external tuples report their total sojourn time
    here (the paper uses Storm's acker tree for this).
    """

    def __init__(
        self,
        operator_names: list[str],
        *,
        n_m: int = 10,
        smoother: str = "ewma",
        smoother_kw: dict | None = None,
    ):
        kw = dict(smoother_kw or {})
        self.names = list(operator_names)
        self.n_m = n_m
        self._probes: dict[str, list[InstanceProbe]] = {n: [] for n in self.names}
        self._metrics = {
            n: OperatorMetrics(
                n,
                make_smoother(smoother, **kw),
                make_smoother(smoother, **kw),
                make_smoother(smoother, **kw),
            )
            for n in self.names
        }
        self._lam0_smoother = make_smoother(smoother, **kw)
        self._sojourn_smoother = make_smoother(smoother, **kw)
        self._lock = threading.Lock()
        self._external_arrivals = 0
        self._sojourn_sum = 0.0
        self._sojourn_n = 0
        self._last_pull_t: float | None = None
        # Per-instance raw service rates from the latest pull (probe order =
        # instance index; NaN for instances with no samples in the window).
        # The scheduler's StragglerDetector consumes this — operator-level
        # aggregation hides *which* instance is slow.
        self.last_instance_mu: dict[str, list[float]] = {}
        # The latest pull's snapshot (None before the first pull).
        self.last_snapshot: MeasurementSnapshot | None = None

    # Registration / reporting ------------------------------------------ #
    def new_probe(self, operator: str) -> InstanceProbe:
        p = InstanceProbe(n_m=self.n_m)
        self._probes[operator].append(p)
        return p

    def on_external_arrival(self, n: int = 1) -> None:
        with self._lock:
            self._external_arrivals += n

    def on_tuple_complete(self, sojourn: float, n: int = 1) -> None:
        """Completion of an external tuple's whole processing tree."""
        with self._lock:
            self._sojourn_sum += sojourn * n
            self._sojourn_n += n

    # Pull layer --------------------------------------------------------- #
    def pull(self, now: float) -> MeasurementSnapshot:
        """T_m-periodic pull: drain probes, aggregate, smooth, snapshot."""
        dt = 0.0 if self._last_pull_t is None else now - self._last_pull_t
        self._last_pull_t = now
        lam = np.full(len(self.names), np.nan)
        mu = np.full(len(self.names), np.nan)
        drop = np.zeros(len(self.names))
        inst_mu: dict[str, list[float]] = {}
        for idx, name in enumerate(self.names):
            arrivals, _processed, st_sum, st_n, dropped = 0, 0, 0.0, 0, 0
            rates: list[float] = []
            for p in self._probes[name]:
                a, pr, s, c, dr = p.drain()
                arrivals += a
                _processed += pr
                st_sum += s
                st_n += c
                dropped += dr
                rates.append(c / s if (c > 0 and s > 0) else float("nan"))
            inst_mu[name] = rates
            m = self._metrics[name]
            m.ingest(arrivals, st_sum, st_n, dt, dropped)
            lam[idx] = m.lam_hat
            mu[idx] = m.mu_hat
            drop[idx] = m.drop_hat
        self.last_instance_mu = inst_mu
        with self._lock:
            ext, self._external_arrivals = self._external_arrivals, 0
            s_sum, self._sojourn_sum = self._sojourn_sum, 0.0
            s_n, self._sojourn_n = self._sojourn_n, 0
        lam0 = self._lam0_smoother.update(ext / dt) if dt > 0 else float("nan")
        soj = (
            self._sojourn_smoother.update(s_sum / s_n)
            if s_n > 0
            else self._sojourn_smoother.value
        )
        self.last_snapshot = MeasurementSnapshot(lam, mu, lam0, soj, now, drop_hat=drop)
        return self.last_snapshot
