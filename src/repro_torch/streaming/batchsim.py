"""Vectorized discrete-time batch simulator (the control loop's "simulate"
and "measure" stages).

B scenarios x N operators advance together through the fluid/queue
recurrence

    served_t   = min(q_t, k * mu_eff * dt)          # drain step-start backlog
    inflow_t   = ext_t + served_{t-1} @ P           # one-step hop delay
    admitted_t = min(inflow_t, max(cap_queue - (q_t - served_t), 0))
    q_{t+1}    = q_t - served_t + admitted_t,  dropped_t = inflow_t - admitted_t

whose window of steps is ``kernels/queue_step``'s ``queue_window`` (one
CUDA kernel per window for CUDA tensors, its plain version for CPU ones).  External
arrivals are pre-sampled counts (numpy, from each scenario's seed), so this
port and the JAX package consume identical randomness.  ``cap_queue =
+inf`` encodes unbounded queues and the ``block`` policy.

The window measurement composes two wait terms per operator
(:func:`composed_wait`): Little's law on the time-averaged backlog minus
the one-step admission floor, and the Allen-Cunneen scaled Erlang-C wait
:func:`stationary_wait` at the admitted rate.

Host-side pieces (:class:`BatchArrays`, :class:`BatchSimResult`) are numpy
records as in ``repro/streaming/batchsim.py``; the report's sojourn runs the
same torch wait on CPU float64 tensors.

:class:`BatchQueueSim` advances the batch window by window (the
window-at-a-time control loop's simulator): ``backend="torch"`` runs
:func:`window_step_fn` on ``device`` (the CUDA device unless told
otherwise: one ``queue_window`` launch per window) in float32, and
``backend="numpy"`` the float64 host twin :func:`_np_window`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = [
    "STATIONARY_K_CAP",
    "little_wait",
    "BatchArrays",
    "BatchSimResult",
    "BatchQueueSim",
    "service_capacity",
    "per_op_service_time",
    "visit_sum_sojourn",
    "stationary_wait",
    "composed_wait",
    "composed_wait_host",
    "window_step_fn",
]

# Cap of the Erlang-B recurrence in stationary_wait: a lane serving with
# more than 512 servers reads B(512), as the JAX package's
# ``lax.fori_loop`` to the cap does.  The masked loop runs to the cap; the
# table route (``k_bound``) stops at a bound the caller already holds on
# the host, so it needs no device-to-host sync.
STATIONARY_K_CAP = 512


def service_capacity(k, mu, group, alpha, speed=None):
    """Per-operator service rate at allocation ``k`` (numpy): replica
    ``k * mu``, chip-gang ``mu * k * eff(k)``, ``speed``-scaled."""
    k = np.maximum(np.asarray(k, dtype=np.float64), 0.0)
    if speed is not None:
        mu = mu * speed
    with np.errstate(divide="ignore", invalid="ignore"):
        eff = 1.0 / (1.0 + alpha * (k - 1.0))
    return np.where(group, mu * k * eff, mu * k)


def per_op_service_time(cap, mu, group):
    """Per-tuple service time: 1/mu per replica server, 1/(gang capacity)
    for chip-gang operators."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(group, np.where(cap > 0, 1.0 / cap, np.inf), 1.0 / mu)


def visit_sum_sojourn(admitted_rate, wait, svc, ext_rate):
    """Eq.-3-style visit-sum E[T]: sum_i admitted_i * (W_i + S_i) / lam0;
    NaN where no external tuples were admitted."""
    contrib = np.where(admitted_rate > 0, admitted_rate * (wait + svc), 0.0)
    total = contrib.sum(axis=-1)
    return np.where(ext_rate > 0, total / np.maximum(ext_rate, 1e-300), np.nan)


def stationary_wait(k, lam, mu, group, alpha, speed=None, ca2=None, cs2=None, *,
                    k_bound: int | None = None):
    """Erlang-C M/M/k waiting time ``C(k, a) / (k*mu - lam)`` at the admitted
    rate ``lam``, scaled by the Allen-Cunneen factor ``(ca2 + cs2) / 2``;
    gang operators collapse to one server at the gang capacity.  Zero where
    the lane is idle, unallocated, or not stable.  Tensors; the dtype
    follows ``mu``.

    ``k_bound=None`` runs the masked Erlang-B loop to
    :data:`STATIONARY_K_CAP`.  A host ``k_bound`` (at most the cap, and at
    least every lane's server count or the cap) computes the rows ``0 ..
    k_bound`` with one ``kernels/erlang_c`` table -- the CUDA kernel for a
    float32 CUDA tensor (float64 on the card raises), the plain version
    in the tensor's dtype on the CPU -- and gathers each lane's row, which
    holds the loop's value bit for bit: the table's step rounds the same
    product, sum and quotient.

    ``1e-300`` guards round to the tensor dtype as the JAX package's weak
    constants do: 0.0 in float32.
    """
    kf = torch.clamp_min(k.to(mu.dtype), 0.0)
    mu_rep = mu if speed is None else mu * speed
    eff = 1.0 / (1.0 + alpha * (kf - 1.0))
    cap = torch.where(group, mu_rep * kf * eff, mu_rep * kf)
    k_srv = torch.where(group, torch.clamp_max(kf, 1.0), kf)
    mu_srv = torch.where(group, cap, mu_rep)
    a = lam / torch.clamp_min(mu_srv, 1e-300)
    if k_bound is None:
        b = torch.ones_like(a)
        for j in range(1, STATIONARY_K_CAP + 1):
            jf = float(j)
            ab = a * b
            b = torch.where(k_srv >= jf, ab / (ab + jf), b)
    else:
        b = _erlang_b_rows(a, k_srv, int(k_bound))
    c = k_srv * b / torch.clamp_min(k_srv - a * (1.0 - b), 1e-300)
    wait = c / torch.clamp_min(k_srv * mu_srv - lam, 1e-300)
    if ca2 is not None or cs2 is not None:
        wait = wait * (0.5 * ((1.0 if ca2 is None else ca2) + (1.0 if cs2 is None else cs2)))
    stable = (lam > 0) & (k_srv >= 1.0) & (lam < k_srv * mu_srv * (1.0 - 1e-9))
    return torch.where(stable, wait, 0.0)


def _erlang_b_rows(a, k_srv, k_bound: int):
    """``B(k_srv, a)`` per lane from one ``[k_bound + 1, S]`` Erlang-B
    table; lanes past ``k_bound`` read row ``k_bound``."""
    from ..kernels.erlang_c import ops as erlang_ops

    if not 0 <= k_bound <= STATIONARY_K_CAP:
        raise ValueError(f"k_bound must be in [0, {STATIONARY_K_CAP}], got {k_bound}")
    table = erlang_ops.erlang_b_table(a.reshape(-1), k_hi=k_bound)
    row = torch.clamp_max(k_srv, float(k_bound)).to(torch.int64)  # k_srv >= 0
    return table.gather(0, row.reshape(1, -1)).reshape(a.shape)


def little_wait(q_mean, admitted_rate, dt: float):
    """Little's-law per-operator wait from a time-averaged backlog, minus
    the one-step admission floor (a tuple admitted at step t is served at
    step t + 1 at the earliest); 0 where nothing was admitted."""
    return torch.where(
        admitted_rate > 0,
        torch.clamp_min(q_mean / torch.clamp_min(admitted_rate, 1e-300) - dt, 0.0),
        0.0,
    )


def composed_wait(q_mean, admitted_rate, dt, span, k, mu, group, alpha,
                  speed=None, ca2=None, cs2=None, *, k_bound: int | None = None):
    """The measurement-surface wait ``max(little, min(stationary, span))``;
    ``k_bound`` as in :func:`stationary_wait`."""
    fluid = little_wait(q_mean, admitted_rate, dt)
    stat = stationary_wait(k, admitted_rate, mu, group, alpha, speed, ca2, cs2,
                           k_bound=k_bound)
    return torch.maximum(fluid, torch.clamp_max(stat, span))


def composed_wait_host(q_mean, admitted_rate, dt, span, k, mu, group, alpha,
                       speed=None, ca2=None, cs2=None) -> np.ndarray:
    """:func:`composed_wait` on host numpy arrays, in float64 on the CPU
    (the masked Erlang-B loop): the twin's measurement surface."""
    def t(x):
        return None if x is None else torch.as_tensor(np.asarray(x), dtype=torch.float64)

    return composed_wait(
        t(q_mean), t(admitted_rate), dt, span, torch.as_tensor(np.asarray(k)), t(mu),
        torch.as_tensor(np.asarray(group)), t(alpha), t(speed), t(ca2), t(cs2),
    ).numpy()


@dataclass(frozen=True)
class BatchArrays:
    """Packed inputs for one batch run (numpy; index order per scenario is
    its AppGraph's operator order, padded to the batch-wide N_max with
    zero-traffic lanes)."""

    ext: np.ndarray  # [T, B, N] external arrival counts per step (tuples)
    routing: np.ndarray  # [B, N, N] expected multiplicities
    mu: np.ndarray  # [B, N] per-processor service-rate priors
    group: np.ndarray  # [B, N] bool: chip-gang scaling
    alpha: np.ndarray  # [B, N] group efficiency rolloff
    cap_queue: np.ndarray  # [B, N] queue bound (+inf = unbounded / block)
    dt: float  # step length (seconds)
    warmup_steps: int  # steps excluded from the run aggregates
    active: np.ndarray  # [B, N] bool: real operator lanes
    speed: np.ndarray | None = None  # [B, N] machine-class speed (None = 1)
    ca2: np.ndarray | None = None  # [B, N] inter-arrival SCV (None = 1)
    cs2: np.ndarray | None = None  # [B, N] service SCV (None = 1)

    def __post_init__(self):
        t, b, n = self.ext.shape
        names = ["routing", "mu", "group", "alpha", "cap_queue", "active"]
        names += [opt for opt in ("speed", "ca2", "cs2") if getattr(self, opt) is not None]
        for name in names:
            got = getattr(self, name).shape
            want = (b, n, n) if name == "routing" else (b, n)
            if got != want:
                raise ValueError(f"{name} must be {want}, got {got}")
        if not 0 <= self.warmup_steps <= t:
            raise ValueError(f"warmup_steps must be in [0, {t}], got {self.warmup_steps}")

    @property
    def steps(self) -> int:
        return self.ext.shape[0]

    @property
    def batch(self) -> int:
        return self.ext.shape[1]

    @property
    def n(self) -> int:
        return self.ext.shape[2]

    def pad_batch(self, b_total: int) -> "BatchArrays":
        """Append ``b_total - B`` inert batch lanes (a fleet mesh's padding):
        zero arrivals and routing, unit service rate, unbounded queues,
        inactive.  They stay zero through the recurrence and the controller
        decides ``"none"`` on them, so padding never moves a real lane."""
        t, b, n = self.ext.shape
        if b_total < b:
            raise ValueError(f"b_total {b_total} < batch {b}")
        if b_total == b:
            return self
        pad = b_total - b

        def ones_or_none(x):
            return None if x is None else np.concatenate([x, np.ones((pad, n))])

        return BatchArrays(
            ext=np.concatenate([self.ext, np.zeros((t, pad, n))], axis=1),
            routing=np.concatenate([self.routing, np.zeros((pad, n, n))]),
            mu=np.concatenate([self.mu, np.ones((pad, n))]),
            group=np.concatenate([self.group, np.zeros((pad, n), dtype=bool)]),
            alpha=np.concatenate([self.alpha, np.zeros((pad, n))]),
            cap_queue=np.concatenate([self.cap_queue, np.full((pad, n), np.inf)]),
            dt=self.dt,
            warmup_steps=self.warmup_steps,
            active=np.concatenate([self.active, np.zeros((pad, n), dtype=bool)]),
            speed=ones_or_none(self.speed),
            ca2=ones_or_none(self.ca2),
            cs2=ones_or_none(self.cs2),
        )


@dataclass
class BatchSimResult:
    """Post-warmup aggregates for every scenario in the batch (numpy)."""

    offered: np.ndarray  # [B, N] tuples offered at each queue tail
    served: np.ndarray  # [B, N] tuples served
    dropped: np.ndarray  # [B, N] tuples shed
    ext_admitted: np.ndarray  # [B] external tuples admitted
    ext_offered: np.ndarray  # [B] external tuples offered
    q_final: np.ndarray  # [B, N] backlog at the horizon
    q_mean: np.ndarray  # [B, N] time-averaged backlog (post-warmup)
    max_backlog: np.ndarray  # [B, N] peak backlog (whole run)
    span: float  # post-warmup simulated seconds
    dt: float  # step length
    arrival_rate: np.ndarray = field(init=False)  # [B, N] offered tuples/s
    drop_rate: np.ndarray = field(init=False)  # [B, N] shed tuples/s

    def __post_init__(self):
        span = max(self.span, 1e-12)
        self.arrival_rate = self.offered / span
        self.drop_rate = self.dropped / span

    def sojourn(self, k, mu, group, alpha, speed=None, *, ca2=None, cs2=None) -> np.ndarray:
        """[B] visit-sum E[T] at allocation ``k``: sum_i admitted_i * (W_i +
        S_i) / external admitted rate, W_i the composed wait; NaN for
        scenarios that admitted no external tuples."""
        cap = service_capacity(k, mu, group, alpha, speed)
        svc = per_op_service_time(cap, mu if speed is None else mu * speed, group)
        span = max(self.span, 1e-12)
        admitted_rate = (self.offered - self.dropped) / span
        ext_rate = self.ext_admitted / span

        wait = composed_wait_host(self.q_mean, admitted_rate, self.dt, span, k, mu, group,
                                  alpha, speed, ca2, cs2)
        return visit_sum_sojourn(admitted_rate, wait, svc, ext_rate)

    def saturated(self, k, mu, group, alpha, speed=None, *, drop_fraction: float = 0.01
                  ) -> np.ndarray:
        """[B, N] bool: offered load at/above capacity, or sustained
        shedding (idle and padding lanes are never saturated)."""
        cap = service_capacity(k, mu, group, alpha, speed)
        hot = (self.arrival_rate >= cap * (1.0 - 1e-9)) | (
            self.drop_rate > drop_fraction * np.maximum(cap, 1e-300)
        )
        return hot & (self.arrival_rate > 0)


def window_step_fn():
    """The batch simulator's window step, in the form the fused control
    loop consumes.

    Returns ``window(q, served_prev, ext_chunk, warm, cap_serve_dt,
    cap_queue, routing)``: advances one control window through
    ``kernels/queue_step``'s ``queue_window`` (one CUDA kernel for the
    whole window on a card; on the CPU its plain version, a loop over the
    chunk's steps) and returns the 15-tuple of
    ``repro.streaming.batchsim.window_step_fn``: ``q, served_prev`` (state),
    the ungated window sums ``offered, served, dropped, ext_admitted,
    ext_offered, q_int, q_max`` and the ``warm``-weighted sums ``offered,
    served, dropped, ext_admitted, ext_offered, q_int``.  ``warm`` holds the
    chunk's 0/1 step weights (a tensor on the lanes' device, or a host
    sequence on the CPU).  The routing product and the two row sums run in
    index order (``queue_step/ref.py``), so the card and the CPU agree bit
    for bit.
    """
    from ..kernels.queue_step import ops as qs_ops

    return qs_ops.queue_window


# --------------------------------------------------------------------------- #
# The window-at-a-time simulator
# --------------------------------------------------------------------------- #
def _np_window(q, served_prev, ext_chunk, warm, cap_serve_dt, cap_queue, routing):
    """Advance one window in float64 numpy (the twin); returns the final
    state and the ``warm``-weighted sums ``(q, served_prev, offered,
    served, dropped, ext_admitted, ext_offered, q_int, q_max)``."""
    b, n = q.shape
    offered = np.zeros((b, n))
    served_sum = np.zeros((b, n))
    dropped = np.zeros((b, n))
    ext_adm = np.zeros(b)
    ext_off = np.zeros(b)
    q_int = np.zeros((b, n))
    q_max = np.zeros((b, n))
    for t in range(ext_chunk.shape[0]):
        ext_t = ext_chunk[t]
        served = np.minimum(q, cap_serve_dt)
        q1 = q - served
        routed = np.einsum("bi,bij->bj", served_prev, routing)
        inflow = ext_t + routed
        space = np.maximum(cap_queue - q1, 0.0)
        admitted = np.minimum(inflow, space)
        drop_t = inflow - admitted
        q = q1 + admitted
        with np.errstate(divide="ignore", invalid="ignore"):
            adm_frac = np.where(inflow > 0, admitted / np.maximum(inflow, 1e-300), 1.0)
        w = warm[t]
        offered += w * inflow
        served_sum += w * served
        dropped += w * drop_t
        ext_adm += w * (ext_t * adm_frac).sum(axis=-1)
        ext_off += w * ext_t.sum(axis=-1)
        q_int += w * q
        q_max = np.maximum(q_max, q)
        served_prev = served
    return q, served_prev, offered, served_sum, dropped, ext_adm, ext_off, q_int, q_max


# The warm-weighted view of window_step_fn's 15 outputs: state, the
# weighted sums, and the ungated peak backlog (at index 8).
_WINDOW_VIEW = (0, 1, 9, 10, 11, 12, 13, 14, 8)


class BatchQueueSim:
    """Stateful batch simulator: B scenarios advanced window by window.

    ``step_window(k, n_steps)`` advances every scenario under its
    allocation ``k`` and returns that window's aggregates (the measurement
    surface the window-at-a-time :class:`~repro_torch.api.session
    .ScenarioRunner` turns into a ``MeasurementBatch``); ``run(k)`` is the
    whole horizon at once.  State and results are float64 numpy.

    ``backend="torch"`` runs each window through :func:`window_step_fn` on
    ``device`` (default: the CUDA device, one ``queue_window`` launch per
    window; on the CPU its plain version) in ``dtype`` (default float32,
    the window kernel's type; float64 on a card raises ``TypeError``, it
    is never cast down), with the arrivals, routing and queue bounds
    staged there once.  ``backend="numpy"`` is the float64 twin
    (:func:`_np_window`, host only).  A window that straddles the warm-up
    boundary is run again through :func:`_np_window` on the gated mask for
    the whole-run sums, as the reference does.
    """

    BACKENDS = ("torch", "numpy")

    def __init__(self, arrays: BatchArrays, *, backend: str = "torch", device=None,
                 dtype=None):
        if backend not in self.BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected one of {self.BACKENDS}")
        self.arrays = arrays
        self.backend = backend
        self._t = 0  # next step index
        b, n = arrays.batch, arrays.n
        self.q = np.zeros((b, n))
        self._served_prev = np.zeros((b, n))
        # Post-warmup whole-run accumulators (the result() view):
        self._offered = np.zeros((b, n))
        self._served = np.zeros((b, n))
        self._dropped = np.zeros((b, n))
        self._ext_adm = np.zeros(b)
        self._ext_off = np.zeros(b)
        self._q_int = np.zeros((b, n))
        self._q_max = np.zeros((b, n))
        self.device = self.dtype = None
        if backend == "torch":
            from ..device import resolve_device

            self.device = resolve_device(device)
            self.dtype = torch.float32 if dtype is None else dtype
            if self.device.type == "cuda" and self.dtype != torch.float32:
                raise TypeError(
                    f"BatchQueueSim: the window kernel runs float32 on the card, got "
                    f"{self.dtype}; pass device='cpu' for the plain window in {self.dtype}"
                )
            self._window = window_step_fn()
            self._ext = self._tensor(arrays.ext)
            self._cap_queue = self._tensor(arrays.cap_queue)
            self._routing = self._tensor(arrays.routing)

    def _tensor(self, x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=self.dtype, device=self.device)

    @property
    def now(self) -> float:
        return self._t * self.arrays.dt

    @property
    def step_index(self) -> int:
        """Next step to simulate (``arrays.steps`` once exhausted)."""
        return self._t

    def capacity(self, k) -> np.ndarray:
        a = self.arrays
        return service_capacity(k, a.mu, a.group, a.alpha, a.speed)

    def step_window(self, k, n_steps: int | None = None) -> dict:
        """Advance ``n_steps`` (default: to the horizon) under allocation
        ``k`` ([B, N] ints).  Returns this window's ungated aggregates
        (offered / served / dropped per op, admitted and offered external
        tuples, mean and final backlog, capacity) as float64 numpy; the
        whole-run accumulators apply the warm-up gate themselves."""
        a = self.arrays
        if n_steps is None:
            n_steps = a.steps - self._t
        n_steps = min(n_steps, a.steps - self._t)
        if n_steps <= 0:
            raise ValueError("simulation horizon exhausted")
        t0, t1 = self._t, self._t + n_steps
        ext_chunk = a.ext[t0:t1]
        warm_run = (np.arange(t0, t1) >= a.warmup_steps).astype(np.float64)
        ones = np.ones(n_steps)
        cap_serve_dt = self.capacity(k) * a.dt
        if self.backend == "torch":
            out = self._window(
                self._tensor(self.q), self._tensor(self._served_prev), self._ext[t0:t1],
                self._tensor(ones), self._tensor(cap_serve_dt), self._cap_queue,
                self._routing,
            )
            (q, served_prev, offered, served_sum, dropped, ext_adm, ext_off, q_int,
             q_max) = (out[i].cpu().numpy().astype(np.float64) for i in _WINDOW_VIEW)
        else:
            (q, served_prev, offered, served_sum, dropped, ext_adm, ext_off, q_int,
             q_max) = _np_window(self.q, self._served_prev, ext_chunk, ones,
                                 cap_serve_dt, a.cap_queue, a.routing)
        if warm_run.all():
            self._offered += offered
            self._served += served_sum
            self._dropped += dropped
            self._ext_adm += ext_adm
            self._ext_off += ext_off
            self._q_int += q_int
        elif warm_run.any():
            (_q2, _sp2, off_w, srv_w, drop_w, ea_w, eo_w, qi_w, _qm2) = _np_window(
                self.q, self._served_prev, ext_chunk, warm_run,
                cap_serve_dt, a.cap_queue, a.routing,
            )
            self._offered += off_w
            self._served += srv_w
            self._dropped += drop_w
            self._ext_adm += ea_w
            self._ext_off += eo_w
            self._q_int += qi_w
        self._q_max = np.maximum(self._q_max, q_max)
        self.q = q
        self._served_prev = served_prev
        self._t = t1
        return {
            "t0": t0 * a.dt,
            "t1": t1 * a.dt,
            "span": n_steps * a.dt,
            "offered": offered,
            "served": served_sum,
            "dropped": dropped,
            "ext_admitted": ext_adm,
            "ext_offered": ext_off,
            "q_mean": q_int / max(n_steps, 1),
            "q_final": q,
            "capacity": cap_serve_dt / a.dt,
        }

    def result(self) -> BatchSimResult:
        """Whole-run (post-warmup) aggregates so far."""
        a = self.arrays
        warm_steps = max(min(self._t, a.steps) - a.warmup_steps, 0)
        return BatchSimResult(
            offered=self._offered.copy(),
            served=self._served.copy(),
            dropped=self._dropped.copy(),
            ext_admitted=self._ext_adm.copy(),
            ext_offered=self._ext_off.copy(),
            q_final=self.q.copy(),
            q_mean=self._q_int / max(warm_steps, 1),
            max_backlog=self._q_max.copy(),
            span=warm_steps * a.dt,
            dt=a.dt,
        )

    def run(self, k) -> BatchSimResult:
        """Advance to the horizon under a fixed allocation and aggregate."""
        self.step_window(k)
        return self.result()
