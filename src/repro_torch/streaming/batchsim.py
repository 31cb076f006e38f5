"""Vectorized discrete-time batch simulator (the control loop's "simulate"
and "measure" stages).

B scenarios x N operators advance together through the fluid/queue
recurrence

    served_t   = min(q_t, k * mu_eff * dt)          # drain step-start backlog
    inflow_t   = ext_t + served_{t-1} @ P           # one-step hop delay
    admitted_t = min(inflow_t, max(cap_queue - (q_t - served_t), 0))
    q_{t+1}    = q_t - served_t + admitted_t,  dropped_t = inflow_t - admitted_t

whose per-step bounded-queue update is ``kernels/queue_step`` (the CUDA
kernel for CUDA tensors, its plain version for CPU ones).  External
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
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = [
    "STATIONARY_K_CAP",
    "BatchArrays",
    "BatchSimResult",
    "service_capacity",
    "stationary_wait",
    "composed_wait",
    "window_step_fn",
]

# Static iteration bound of the masked Erlang-B recurrence in
# stationary_wait (iterations past a lane's k are masked no-ops).  The loop
# always runs to the cap: stopping at max(k) would need a device-to-host
# sync every tick.
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


def _per_op_service_time(cap, mu, group):
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(group, np.where(cap > 0, 1.0 / cap, np.inf), 1.0 / mu)


def _visit_sum_sojourn(admitted_rate, wait, svc, ext_rate):
    contrib = np.where(admitted_rate > 0, admitted_rate * (wait + svc), 0.0)
    total = contrib.sum(axis=-1)
    return np.where(ext_rate > 0, total / np.maximum(ext_rate, 1e-300), np.nan)


def stationary_wait(k, lam, mu, group, alpha, speed=None, ca2=None, cs2=None):
    """Erlang-C M/M/k waiting time ``C(k, a) / (k*mu - lam)`` at the admitted
    rate ``lam``, scaled by the Allen-Cunneen factor ``(ca2 + cs2) / 2``;
    gang operators collapse to one server at the gang capacity.  Zero where
    the lane is idle, unallocated, or not stable.  Tensors; the dtype
    follows ``mu``.

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
    b = torch.ones_like(a)
    for j in range(1, STATIONARY_K_CAP + 1):
        jf = float(j)
        ab = a * b
        b = torch.where(k_srv >= jf, ab / (ab + jf), b)
    c = k_srv * b / torch.clamp_min(k_srv - a * (1.0 - b), 1e-300)
    wait = c / torch.clamp_min(k_srv * mu_srv - lam, 1e-300)
    if ca2 is not None or cs2 is not None:
        wait = wait * (0.5 * ((1.0 if ca2 is None else ca2) + (1.0 if cs2 is None else cs2)))
    stable = (lam > 0) & (k_srv >= 1.0) & (lam < k_srv * mu_srv * (1.0 - 1e-9))
    return torch.where(stable, wait, 0.0)


def composed_wait(q_mean, admitted_rate, dt, span, k, mu, group, alpha,
                  speed=None, ca2=None, cs2=None):
    """The measurement-surface wait ``max(little, min(stationary, span))``."""
    fluid = torch.where(
        admitted_rate > 0,
        torch.clamp_min(q_mean / torch.clamp_min(admitted_rate, 1e-300) - dt, 0.0),
        0.0,
    )
    stat = stationary_wait(k, admitted_rate, mu, group, alpha, speed, ca2, cs2)
    return torch.maximum(fluid, torch.clamp_max(stat, span))


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
        svc = _per_op_service_time(cap, mu if speed is None else mu * speed, group)
        span = max(self.span, 1e-12)
        admitted_rate = (self.offered - self.dropped) / span
        ext_rate = self.ext_admitted / span

        def t(x):
            return None if x is None else torch.as_tensor(np.asarray(x), dtype=torch.float64)

        wait = composed_wait(
            t(self.q_mean), t(admitted_rate), self.dt, span,
            torch.as_tensor(np.asarray(k)), t(mu), torch.as_tensor(np.asarray(group)),
            t(alpha), t(speed), t(ca2), t(cs2),
        ).numpy()
        return _visit_sum_sojourn(admitted_rate, wait, svc, ext_rate)

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
    cap_queue, routing)``: advances one control window (a Python loop over
    the chunk's steps, each step's bounded-queue update through
    ``kernels/queue_step``) and returns the 15-tuple of
    ``repro.streaming.batchsim.window_step_fn``: ``q, served_prev`` (state),
    the ungated window sums ``offered, served, dropped, ext_admitted,
    ext_offered, q_int, q_max`` and the ``warm``-weighted sums ``offered,
    served, dropped, ext_admitted, ext_offered, q_int``.  ``warm`` is a
    host sequence of 0/1 step weights.  The accumulators are updated in
    place.
    """
    from ..kernels.queue_step import ops as qs_ops

    def window(q, served_prev, ext_chunk, warm, cap_serve_dt, cap_queue, routing):
        b, n = q.shape
        capq_flat = cap_queue.reshape(-1)
        caps_flat = cap_serve_dt.reshape(-1)
        zeros = torch.zeros_like(q)
        zb = torch.zeros(b, dtype=q.dtype, device=q.device)
        offered, served_sum, dropped = zeros.clone(), zeros.clone(), zeros.clone()
        ext_adm, ext_off = zb.clone(), zb.clone()
        q_int, q_max = zeros.clone(), zeros.clone()
        w_off, w_srv, w_drop = zeros.clone(), zeros.clone(), zeros.clone()
        w_ea, w_eo, w_qi = zb.clone(), zb.clone(), zeros.clone()
        for t in range(ext_chunk.shape[0]):
            ext_t = ext_chunk[t]
            w = float(warm[t])
            routed = torch.bmm(served_prev[:, None, :], routing)[:, 0, :]  # bi,bij->bj
            inflow = ext_t + routed
            q_next_f, served_f, drop_f = qs_ops.queue_step(
                q.reshape(-1), inflow.reshape(-1), caps_flat, capq_flat
            )
            q = q_next_f.reshape(b, n)
            served = served_f.reshape(b, n)
            drop_t = drop_f.reshape(b, n)
            admitted = inflow - drop_t
            adm_frac = torch.where(
                inflow > 0, admitted / torch.clamp_min(inflow, 1e-300), 1.0
            )
            ext_adm_t = (ext_t * adm_frac).sum(dim=-1)
            ext_off_t = ext_t.sum(dim=-1)
            # acc += w * x: with w in {0, 1} one add-with-alpha equals the
            # separate multiply and add bit for bit.
            offered.add_(inflow)
            served_sum.add_(served)
            dropped.add_(drop_t)
            ext_adm.add_(ext_adm_t)
            ext_off.add_(ext_off_t)
            q_int.add_(q)
            torch.maximum(q_max, q, out=q_max)
            w_off.add_(inflow, alpha=w)
            w_srv.add_(served, alpha=w)
            w_drop.add_(drop_t, alpha=w)
            w_ea.add_(ext_adm_t, alpha=w)
            w_eo.add_(ext_off_t, alpha=w)
            w_qi.add_(q, alpha=w)
            served_prev = served
        return (q, served_prev, offered, served_sum, dropped, ext_adm, ext_off,
                q_int, q_max, w_off, w_srv, w_drop, w_ea, w_eo, w_qi)

    return window
