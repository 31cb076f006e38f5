"""MPC lookahead planner: price a few candidate allocations against the
forecast horizon and commit the cheapest that keeps E[T] under T_max (the
port's copy of ``repro/forecast/mpc.py``).

Each tick the planner

1. takes the predicted per-operator offered rates ``lam_pred [B, H, N]``;
2. sizes Program (6) at the predicted peak in closed form: per-lane
   Algorithm-1 gains are non-increasing, so the greedy's E[T] after m
   increments is the floor's E[T] less the running sum of the sorted gains
   over ``lam0`` -- a sort and a prefix sum;
3. builds the candidates: hold the allocation, the Program-6-at-peak
   budget and its +/- ``neighbor`` budgets, each placed by the masked top-R
   gain selection (``kernels/gain_topr``), or by the fused decide pass
   (``kernels/decide_fused``, ``k_cur = 0``) when the caller hands one in;
4. prices every candidate at every horizon step as the worse of the
   steady-state visit-sum E[T] and a bounded-queue fluid rollout from the
   actual backlog;
5. picks the cheapest candidate under T_max across the horizon (ties and
   near-equal budgets prefer holding).

``any_ok = False`` and a closed confidence gate both hand the tick back to
the reactive decide.  Two faces, as in :mod:`.predictors`: the numpy face
(:func:`mpc_plan`, :func:`sojourn_table_arrays`, :func:`gain_topr_np`,
:class:`ProactiveController`) is the float64 twin, op for op the
reference's; the torch face (:func:`mpc_plan_torch`,
:func:`sojourn_table_arrays_torch`, :func:`forecast_step_torch`) runs in
the fused loop on the tensors' device, its Erlang-B rows from one
``kernels/erlang_c`` launch over the flattened ``[B (H+1) N]`` loads.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from .predictors import (
    PredictorParams,
    confidence,
    confidence_torch,
    error_init,
    error_init_torch,
    error_update,
    error_update_torch,
    forecast_rates,
    forecast_rates_torch,
    history_init,
    history_init_torch,
    history_push,
    history_push_torch,
)

__all__ = [
    "MPCConfig",
    "ProactiveController",
    "forecast_init_state",
    "forecast_step",
    "mpc_plan",
    "mpc_plan_compact",
    "gain_topr_np",
    "sojourn_table_arrays",
    "forecast_init_state_torch",
    "forecast_step_torch",
    "sojourn_table_arrays_torch",
    "mpc_plan_torch",
]

_TINY = 1e-300


def _quiet(fn):
    """The masked-inf arithmetic of the numpy face is deliberate (infeasible
    lanes price to inf and are where()-ed out)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            return fn(*args, **kwargs)

    return wrapped


@dataclass(frozen=True)
class MPCConfig:
    """Knobs of the proactive mode: the lookahead ``horizon`` in ticks, the
    rate-history ``window``, the predictor, the +/- budget step
    ``neighbor``, the Program-(6) ``headroom``, the confidence gate
    (``min_scored``, ``mase_gate``, ``smape_gate``) and the scale-in
    hysteresis."""

    horizon: int = 3
    window: int = 12
    predictor: PredictorParams = field(default_factory=PredictorParams)
    neighbor: int = 2
    headroom: float = 1.1
    min_scored: int = 3
    mase_gate: float = 2.0
    smape_gate: float = 0.25
    scale_in_hysteresis: float = 0.8

    def __post_init__(self):
        if self.horizon < 1:
            raise ValueError(f"need horizon >= 1 ticks, got {self.horizon}")
        if self.window < 2:
            raise ValueError(f"need window >= 2 ticks, got {self.window}")
        if self.predictor.kind == "seasonal" and self.window < self.predictor.season:
            raise ValueError(
                f"window {self.window} must cover one season "
                f"({self.predictor.season} ticks) for the seasonal predictor"
            )
        if self.neighbor < 1:
            raise ValueError(f"need neighbor >= 1, got {self.neighbor}")
        if not 0.0 <= self.scale_in_hysteresis <= 1.0:
            raise ValueError(
                f"need 0 <= scale_in_hysteresis <= 1, got {self.scale_in_hysteresis}"
            )


# --------------------------------------------------------------------------- #
# numpy face (the float64 twin)
# --------------------------------------------------------------------------- #
def forecast_init_state(b: int, n: int, cfg: MPCConfig, dtype=np.float64):
    """``(hist [B,W,N], prev_pred, prev_y, abs_err, naive_err, smape_sum,
    n_obs)``: the history window and the error tracker as one tuple."""
    return (history_init(b, cfg.window, n, dtype=dtype),) + error_init(b, n, dtype=dtype)


def forecast_step(state, lam_hat, active, cfg: MPCConfig):
    """One tick of the predictor plane: push the window's measured rates
    (non-finite / inactive lanes as 0), forecast, score, gate.  Returns
    ``(state', lam_pred [B, H, N], confident [B])``."""
    hist, err = state[0], state[1:]
    y = np.where(active & np.isfinite(lam_hat), lam_hat, 0.0)
    hist = history_push(hist, y, err[5])
    lam_pred = forecast_rates(hist, cfg.horizon, cfg.predictor)
    err = error_update(err, lam_pred[:, 0, :], y)
    conf = confidence(err, active, min_scored=cfg.min_scored, mase_gate=cfg.mase_gate,
                      smape_gate=cfg.smape_gate)
    return (hist,) + err, lam_pred, conf


@_quiet
def sojourn_table_arrays(lam, mu, group, alpha, k_hi: int):
    """``[..., N] -> [..., N, K+1]`` E[T_i](k) table, min_k = 1: the
    Erlang-B recursion ``b = a b / (j + a b)``, the Erlang-C conversion and
    the group M/M/1 closed form."""
    dtype = lam.dtype
    a_rep = lam / mu
    b = np.ones_like(a_rep)
    rows = [b]
    for j in range(1, k_hi + 1):
        b = a_rep * b / (j + a_rep * b)
        rows.append(b)
    btab = np.stack(rows, axis=-1)  # [..., N, K+1]
    ks = np.arange(k_hi + 1, dtype=dtype)
    kk = ks[(None,) * (lam.ndim)]
    c = kk * btab / (kk - a_rep[..., None] * (1.0 - btab))
    t_rep = c / (kk * mu[..., None] - lam[..., None]) + 1.0 / mu[..., None]
    t_rep = np.where(kk > a_rep[..., None], t_rep, np.inf)
    eff = 1.0 / (1.0 + alpha[..., None] * (kk - 1.0))
    mu_eff = mu[..., None] * kk * eff
    a_grp = lam[..., None] / mu_eff
    bg = a_grp / (1.0 + a_grp)
    cg = bg / (1.0 - a_grp * (1.0 - bg))
    t_grp = cg / (mu_eff - lam[..., None]) + 1.0 / mu_eff
    t_grp = np.where(a_grp < 1.0, t_grp, np.inf)
    T = np.where(group[..., None], t_grp, t_rep)
    return np.where(kk >= 1.0, T, np.inf)


def gain_topr_np(cand, budget):
    """Numpy float64 top-R selection (threshold + row-major tie split), take
    for take the plain ``kernels/gain_topr``."""
    cand = np.asarray(cand, dtype=np.float64)
    budget = np.asarray(budget, dtype=np.int64)
    b, n, j = cand.shape
    flat = cand.reshape(b, n * j)
    pos = flat > 0
    pos_row = (cand > 0).sum(axis=-1)
    total_pos = pos.sum(axis=-1)
    use_all = total_pos <= budget
    vals = np.sort(np.where(pos, flat, -np.inf), axis=-1)[:, ::-1]
    idx = np.clip(budget - 1, 0, n * j - 1)
    thresh = np.take_along_axis(vals, idx[:, None], axis=-1)[:, 0]
    strict = ((cand > thresh[:, None, None]) & (cand > 0)).sum(-1)
    ties = ((cand == thresh[:, None, None]) & (cand > 0)).sum(-1)
    rem = budget - strict.sum(axis=-1)
    before = np.cumsum(ties, axis=-1) - ties
    extra = np.clip(np.minimum(ties, rem[:, None] - before), 0, None)
    take = np.where(use_all[:, None], pos_row, strict + extra)
    return np.where(budget[:, None] > 0, take, 0).astype(np.int64)


def _capacity(k, mu_eff, group, alpha):
    """Service capacity at allocation ``k`` (group rolloff; k floored at 0,
    the fused simulator's rule)."""
    kf = np.maximum(k, 0) * np.ones_like(mu_eff)
    eff = 1.0 / (1.0 + alpha * (kf - 1.0))
    return np.where(group, mu_eff * kf * eff, mu_eff * kf)


def _price(T, k_vec, lam, lam0, k_hi: int):
    """Visit-sum E[T] of allocation ``k_vec [..., N]`` under table ``T
    [..., N, K+1]`` at rates ``lam [..., N]`` / external ``lam0 [...]``."""
    idx = np.clip(k_vec, 0, k_hi)[..., None]
    per_op = np.take_along_axis(T, idx, axis=-1)[..., 0]
    contrib = np.where(lam > 0, lam * per_op, 0.0)
    return contrib.sum(axis=-1) / np.maximum(lam0, _TINY)


@_quiet
def mpc_plan(lam_pred, q0, k_cur, *, mu, group, alpha, speed, active, src_mask, cap_queue,
             t_max, k_max, span: float, cfg: MPCConfig, k_hi: int, topr=None, alloc=None):
    """One planning pass over the forecast horizon (float64 numpy twin).

    ``lam_pred [B, H, N]`` predicted offered rates, ``q0 [B, N]`` backlog,
    ``k_cur [B, N]`` allocation, ``mu/group/alpha/speed/active/src_mask/
    cap_queue [B, N]`` statics, ``t_max [B]`` (inf: no constraint), ``k_max
    [B]`` budgets, ``span`` seconds per tick.  ``topr(cand [M, N, J],
    budget [M]) -> take [M, N]`` is the top-R selection (default
    :func:`gain_topr_np`).  ``alloc(lam_m [M, N], budgets_m [M]) -> k_alloc
    [M, N]``, when given, replaces the floor and top-R block with one
    allocator call over every candidate budget (absolute totals: the hook
    recomputes the same floor and spends ``budget - floor``).  Returns
    ``(k_plan [B, N], any_ok [B], et_hold [B], et_plan [B], need [B])``.
    """
    if topr is None:
        topr = gain_topr_np
    dtype = lam_pred.dtype
    b, h, n = lam_pred.shape
    lam_pred = np.where(active[:, None, :], lam_pred, 0.0)
    mu_eff = mu * speed
    lam_peak = lam_pred.max(axis=1)  # [B, N]

    # One table pass for the peak and every horizon step: [B, H+1, N, K+1].
    lam_all = np.concatenate([lam_peak[:, None, :], lam_pred], axis=1)
    shape = lam_all.shape
    T_all = sojourn_table_arrays(
        lam_all,
        np.broadcast_to(mu_eff[:, None, :], shape) + np.zeros(shape, dtype=dtype),
        np.broadcast_to(group[:, None, :], shape),
        np.broadcast_to(alpha[:, None, :], shape) + np.zeros(shape, dtype=dtype),
        k_hi,
    )
    T_peak = T_all[:, 0]
    T_h = T_all[:, 1:]
    lam0_h = np.maximum(np.where(src_mask[:, None, :], lam_pred, 0.0).sum(axis=-1), _TINY)
    lam0_peak = np.maximum(np.where(src_mask, lam_peak, 0.0).sum(axis=-1), _TINY)

    # Minimal feasible allocation at the predicted peak (first finite col).
    finite = np.isfinite(T_peak)
    has_finite = finite.any(axis=-1)
    first = np.argmax(finite, axis=-1).astype(np.int32)
    k_start = np.where(active, np.where(has_finite, first, k_hi + 1), 0).astype(np.int32)
    floor_total = k_start.sum(axis=-1)

    # Algorithm-1 candidate gains from k_start at the predicted peak.
    G = lam_peak[..., None] * (T_peak[..., :-1] - T_peak[..., 1:])
    G = np.where(np.isfinite(T_peak[..., :-1]), G, np.inf)
    j = np.arange(k_hi, dtype=np.int32)
    idx = k_start[..., None] + j[None, None, :]
    cand = np.take_along_axis(G, np.clip(idx, 0, k_hi - 1), axis=-1)
    cand = np.where((idx < k_hi) & active[..., None] & np.isfinite(cand), cand, 0.0)

    # Program (6) at the peak in closed form: count the increments whose
    # E[T] still exceeds T_max.
    et_floor = _price(T_peak, k_start, lam_peak, lam0_peak, k_hi)
    g_sorted = np.sort(cand.reshape(b, n * k_hi), axis=-1)[:, ::-1]
    ets = et_floor[:, None] - np.cumsum(g_sorted, axis=-1) / lam0_peak[:, None]
    need_extra = np.where(et_floor > t_max, 1, 0) + (ets[:, :-1] > t_max[:, None]).sum(axis=-1)
    need = np.ceil((floor_total + need_extra) * cfg.headroom).astype(np.int32)

    # Candidates: hold, Program-6-at-peak, +/- neighbor.
    step = int(cfg.neighbor)
    budgets = np.stack([need, need - step, need + step], axis=-1)  # [B, 3]
    budgets = np.clip(budgets, floor_total[:, None], k_max[:, None])
    if alloc is not None:
        lam_rep = np.broadcast_to(lam_peak[:, None, :], (b, 3, n)).reshape(b * 3, n)
        k_alloc = np.asarray(alloc(lam_rep, budgets.reshape(b * 3))).reshape(b, 3, n)
        k_alloc = k_alloc.astype(np.int32)
    else:
        extra = np.clip(budgets - floor_total[:, None], 0, None).astype(np.int32)
        cand_rep = np.broadcast_to(cand[:, None, :, :], (b, 3, n, k_hi)).reshape(b * 3, n,
                                                                                  k_hi)
        take = topr(cand_rep, extra.reshape(b * 3))
        k_alloc = k_start[:, None, :] + take.reshape(b, 3, n).astype(np.int32)
    k_alloc = np.where(active[:, None, :], k_alloc, 0)
    k_hold = np.where(active, k_cur, 0).astype(np.int32)[:, None, :]
    k_cand = np.concatenate([k_hold, k_alloc], axis=1)  # [B, C=4, N]

    # Price every candidate at every horizon step: steady state...
    kc = np.clip(k_cand, 0, k_hi).astype(np.int32)
    per_op = np.take_along_axis(T_h[:, None], kc[:, :, None, :, None], axis=-1)[..., 0]
    lam_h = lam_pred[:, None]  # [B, 1, H, N]
    contrib = np.where(lam_h > 0, lam_h * per_op, 0.0)
    et_a = contrib.sum(axis=-1) / lam0_h[:, None, :]  # [B, C, H]

    # ...and a bounded-queue fluid rollout from the actual backlog.
    cap_rate = _capacity(k_cand, mu_eff[:, None, :], group[:, None, :], alpha[:, None, :])
    svc = np.where(
        group[:, None, :],
        np.where(cap_rate > 0, 1.0 / np.maximum(cap_rate, _TINY), np.inf),
        1.0 / mu_eff[:, None, :],
    )
    q = np.where(active, q0, 0.0)[:, None, :] + np.zeros_like(cap_rate)
    et_roll = []
    for hi in range(h):
        lam_s = lam_pred[:, hi][:, None, :]
        avail = q + lam_s * span
        served = np.minimum(avail, cap_rate * span)
        q = np.minimum(avail - served, cap_queue[:, None, :])
        wait = np.where(cap_rate > 0, q / np.maximum(cap_rate, _TINY), np.inf)
        contrib_r = np.where(lam_s > 0, lam_s * (wait + svc), 0.0)
        et_roll.append(contrib_r.sum(axis=-1) / lam0_h[:, hi][:, None])
    et_r = np.stack(et_roll, axis=-1)
    et_hat = np.maximum(et_a, et_r)

    # Feasible: under T_max across the horizon and within budget.
    tot = k_cand.sum(axis=-1)  # [B, C]
    ok = (
        (et_hat <= t_max[:, None, None]).all(axis=-1)
        & (tot <= k_max[:, None])
        & (floor_total <= k_max)[:, None]
    )
    score = np.where(ok, tot.astype(dtype), np.inf)
    choice = np.argmin(score, axis=-1)  # first min: ties prefer holding
    chosen_tot = np.take_along_axis(tot, choice[:, None], axis=-1)[:, 0]
    hold_tot = tot[:, 0]
    keep_hold = (
        ok[:, 0]
        & (chosen_tot < hold_tot)
        & (chosen_tot > cfg.scale_in_hysteresis * hold_tot)
    )
    choice = np.where(keep_hold, 0, choice)
    k_plan = np.take_along_axis(k_cand, choice[:, None, None], axis=1)[:, 0]
    et_plan = np.take_along_axis(et_hat, choice[:, None, None], axis=1)[:, 0, 0]
    return k_plan, ok.any(axis=-1), et_hat[:, 0, 0], et_plan, need


def mpc_plan_compact(eligible, lam_pred, q0, k_cur, *, k_max, **plan_kw):
    """:func:`mpc_plan` over the ``eligible [B]`` lanes only.  A plan is
    committed only where the caller's gate (a subset of ``eligible``) is
    open, and the planner is per-lane, so the priced lanes equal a dense
    pass bitwise; the rest return the fall-back row (hold allocation,
    ``any_ok`` False, inf E[T], ``need`` 0)."""
    b = lam_pred.shape[0]
    active = np.asarray(plan_kw["active"], dtype=bool)
    k_plan = np.where(active, np.asarray(k_cur), 0).astype(np.int32)
    any_ok = np.zeros(b, dtype=bool)
    et_hold = np.full(b, np.inf, dtype=lam_pred.dtype)
    et_plan = np.full(b, np.inf, dtype=lam_pred.dtype)
    need = np.zeros(b, dtype=np.int32)
    idx = np.nonzero(np.asarray(eligible, dtype=bool))[0]
    if idx.size:

        def gather(v):
            arr = np.asarray(v)
            return arr[idx] if arr.ndim >= 1 and arr.shape[0] == b else v

        kp, ok, eh, ep, nd = mpc_plan(
            lam_pred[idx], np.asarray(q0)[idx], np.asarray(k_cur)[idx],
            k_max=np.asarray(k_max)[idx],
            **{key: gather(val) for key, val in plan_kw.items()},
        )
        k_plan[idx] = kp
        any_ok[idx] = ok
        et_hold[idx] = eh
        et_plan[idx] = ep
        need[idx] = nd
    return k_plan, any_ok, et_hold, et_plan, need


@dataclass
class ProactiveController:
    """Forecast state and the rollout's statics for the float64 twin paths
    (``tick_batch`` and ``DRSScheduler``); ``mpc_used`` / ``confident`` /
    ``need`` hold the last tick's ``[B]`` outcomes."""

    cfg: MPCConfig
    cap_queue: np.ndarray  # [B, N]
    span: float
    state: tuple
    mpc_used: np.ndarray | None = None
    confident: np.ndarray | None = None
    need: np.ndarray | None = None

    @classmethod
    def create(cls, b: int, n: int, cfg: MPCConfig, *, cap_queue=None,
               span: float = 10.0) -> "ProactiveController":
        cap = (np.full((b, n), np.inf) if cap_queue is None
               else np.asarray(cap_queue, dtype=np.float64))
        return cls(cfg, cap, float(span), forecast_init_state(b, n, cfg))


# --------------------------------------------------------------------------- #
# torch face (the fused loop)
# --------------------------------------------------------------------------- #
def forecast_init_state_torch(b: int, n: int, cfg: MPCConfig, *, dtype, device):
    """:func:`forecast_init_state` as tensors (each leaf its own buffer)."""
    return (history_init_torch(b, cfg.window, n, dtype=dtype, device=device),) + \
        error_init_torch(b, n, dtype=dtype, device=device)


def forecast_step_torch(state, lam_hat, active, cfg: MPCConfig):
    """:func:`forecast_step` on tensors."""
    hist, err = state[0], state[1:]
    y = torch.where(active & torch.isfinite(lam_hat), lam_hat, 0.0)
    hist = history_push_torch(hist, y, err[5])
    lam_pred = forecast_rates_torch(hist, cfg.horizon, cfg.predictor)
    err = error_update_torch(err, lam_pred[:, 0, :], y)
    conf = confidence_torch(err, active, min_scored=cfg.min_scored,
                            mase_gate=cfg.mase_gate, smape_gate=cfg.smape_gate)
    return (hist,) + err, lam_pred, conf


def sojourn_table_arrays_torch(lam, mu, group, alpha, k_hi: int):
    """:func:`sojourn_table_arrays` on tensors: the table of
    :func:`repro_torch.core.batched.sojourn_table_torch` over the flattened
    lanes, whose Erlang-B rows are one ``kernels/erlang_c`` launch on a
    card.  Its plain recurrence forms ``ab / (ab + j)``, the reference's
    ``a b / (j + a b)`` with the addends swapped: the same bits."""
    from ..core.batched import sojourn_table_torch

    shape = lam.shape
    s = lam.numel()
    T = sojourn_table_torch(
        lam.reshape(-1), mu.reshape(-1), k_hi=k_hi, group=group.reshape(-1),
        alpha=alpha.reshape(-1),
        min_k=torch.ones(s, dtype=torch.int32, device=lam.device),
    )
    return T.reshape(*shape, k_hi + 1)


def _capacity_torch(k, mu_eff, group, alpha):
    kf = torch.clamp_min(k, 0).to(mu_eff.dtype) * torch.ones_like(mu_eff)
    eff = 1.0 / (1.0 + alpha * (kf - 1.0))
    return torch.where(group, mu_eff * kf * eff, mu_eff * kf)


def _price_torch(T, k_vec, lam, lam0, k_hi: int):
    idx = torch.clamp(k_vec.to(torch.int64), 0, k_hi)[..., None]
    per_op = torch.gather(T, -1, idx)[..., 0]
    contrib = torch.where(lam > 0, lam * per_op, 0.0)
    return contrib.sum(dim=-1) / torch.clamp_min(lam0, _TINY)


def mpc_plan_torch(lam_pred, q0, k_cur, *, mu, group, alpha, speed, active, src_mask,
                   cap_queue, t_max, k_max, span: float, cfg: MPCConfig, k_hi: int,
                   alloc=None):
    """:func:`mpc_plan` on tensors (all on one device, floats in
    ``lam_pred``'s dtype), the top-R selection through ``kernels/gain_topr``.
    ``alloc(lam_m [M, N], budgets_m [M]) -> k [M, N]``, when given, replaces
    the floor + top-R block by one allocator call over the 3 candidate
    budgets per scenario (absolute totals; the fused decide pass with
    ``k_cur = 0`` recomputes the same floor and spends ``budget -
    floor``).  The integer outputs are int32."""
    from ..kernels.gain_topr import ops as topr_ops

    dtype, dev = lam_pred.dtype, lam_pred.device
    b, h, n = lam_pred.shape
    inf = float("inf")
    lam_pred = torch.where(active[:, None, :], lam_pred, 0.0)
    mu_eff = mu * speed
    lam_peak = lam_pred.amax(dim=1)

    lam_all = torch.cat([lam_peak[:, None, :], lam_pred], dim=1)
    shape = lam_all.shape
    T_all = sojourn_table_arrays_torch(
        lam_all, mu_eff[:, None, :].expand(shape), group[:, None, :].expand(shape),
        alpha[:, None, :].expand(shape), k_hi,
    )
    T_peak = T_all[:, 0]
    T_h = T_all[:, 1:]
    lam0_h = torch.clamp_min(torch.where(src_mask[:, None, :], lam_pred, 0.0).sum(dim=-1),
                             _TINY)
    lam0_peak = torch.clamp_min(torch.where(src_mask, lam_peak, 0.0).sum(dim=-1), _TINY)

    finite = torch.isfinite(T_peak)
    has_finite = finite.any(dim=-1)
    first = torch.argmax(finite.to(torch.uint8), dim=-1).to(torch.int32)
    k_start = torch.where(active, torch.where(has_finite, first, k_hi + 1), 0).to(torch.int32)
    floor_total = k_start.sum(dim=-1)  # int64

    G = lam_peak[..., None] * (T_peak[..., :-1] - T_peak[..., 1:])
    G = torch.where(torch.isfinite(T_peak[..., :-1]), G, inf)
    j = torch.arange(k_hi, dtype=torch.int64, device=dev)
    idx = k_start[..., None].to(torch.int64) + j[None, None, :]
    cand = torch.gather(G, -1, torch.clamp(idx, 0, k_hi - 1))
    cand = torch.where((idx < k_hi) & active[..., None] & torch.isfinite(cand), cand, 0.0)

    et_floor = _price_torch(T_peak, k_start, lam_peak, lam0_peak, k_hi)
    g_sorted = torch.sort(cand.reshape(b, n * k_hi), dim=-1, descending=True).values
    ets = et_floor[:, None] - torch.cumsum(g_sorted, dim=-1) / lam0_peak[:, None]
    need_extra = (et_floor > t_max).to(torch.int64) + (ets[:, :-1] > t_max[:, None]).sum(dim=-1)
    need = torch.ceil((floor_total + need_extra).to(dtype) * cfg.headroom).to(torch.int32)

    step = int(cfg.neighbor)
    budgets = torch.stack([need, need - step, need + step], dim=-1).to(torch.int64)
    budgets = torch.minimum(torch.maximum(budgets, floor_total[:, None]),
                            k_max.to(torch.int64)[:, None])  # np.clip's order
    if alloc is not None:
        lam_rep = lam_peak[:, None, :].expand(b, 3, n).reshape(b * 3, n)
        k_alloc = alloc(lam_rep, budgets.reshape(b * 3)).reshape(b, 3, n).to(torch.int32)
    else:
        extra = torch.clamp_min(budgets - floor_total[:, None], 0).to(torch.int32)
        cand_rep = cand[:, None].expand(b, 3, n, k_hi).reshape(b * 3, n, k_hi)
        take = topr_ops.gain_topr(cand_rep.contiguous(), extra.reshape(b * 3))
        k_alloc = k_start[:, None, :] + take.reshape(b, 3, n).to(torch.int32)
    k_alloc = torch.where(active[:, None, :], k_alloc, 0)
    k_hold = torch.where(active, k_cur.to(torch.int32), 0)[:, None, :]
    k_cand = torch.cat([k_hold, k_alloc.to(torch.int32)], dim=1)  # [B, C=4, N]
    c = k_cand.shape[1]

    kc = torch.clamp(k_cand.to(torch.int64), 0, k_hi)
    per_op = torch.gather(
        T_h[:, None].expand(b, c, h, n, k_hi + 1), -1,
        kc[:, :, None, :, None].expand(b, c, h, n, 1),
    )[..., 0]  # [B, C, H, N]
    lam_h = lam_pred[:, None]
    contrib = torch.where(lam_h > 0, lam_h * per_op, 0.0)
    et_a = contrib.sum(dim=-1) / lam0_h[:, None, :]

    cap_rate = _capacity_torch(k_cand, mu_eff[:, None, :], group[:, None, :],
                               alpha[:, None, :])
    svc = torch.where(
        group[:, None, :],
        torch.where(cap_rate > 0, 1.0 / torch.clamp_min(cap_rate, _TINY), inf),
        1.0 / mu_eff[:, None, :],
    )
    q = torch.where(active, q0, 0.0)[:, None, :] + torch.zeros_like(cap_rate)
    et_roll = []
    for hi in range(h):
        lam_s = lam_pred[:, hi][:, None, :]
        avail = q + lam_s * span
        served = torch.minimum(avail, cap_rate * span)
        q = torch.minimum(avail - served, cap_queue[:, None, :])
        wait = torch.where(cap_rate > 0, q / torch.clamp_min(cap_rate, _TINY), inf)
        contrib_r = torch.where(lam_s > 0, lam_s * (wait + svc), 0.0)
        et_roll.append(contrib_r.sum(dim=-1) / lam0_h[:, hi][:, None])
    et_r = torch.stack(et_roll, dim=-1)
    et_hat = torch.maximum(et_a, et_r)

    tot = k_cand.sum(dim=-1)  # [B, C] int64
    k_max64 = k_max.to(torch.int64)
    ok = (
        (et_hat <= t_max[:, None, None]).all(dim=-1)
        & (tot <= k_max64[:, None])
        & (floor_total <= k_max64)[:, None]
    )
    score = torch.where(ok, tot.to(dtype), inf)
    choice = torch.argmin(score, dim=-1)  # first min: ties prefer holding
    chosen_tot = torch.gather(tot, 1, choice[:, None])[:, 0]
    hold_tot = tot[:, 0]
    keep_hold = (
        ok[:, 0]
        & (chosen_tot < hold_tot)
        & (chosen_tot.to(dtype) > cfg.scale_in_hysteresis * hold_tot.to(dtype))
    )
    choice = torch.where(keep_hold, 0, choice)
    k_plan = torch.gather(k_cand, 1, choice[:, None, None].expand(b, 1, n))[:, 0]
    et_plan = torch.gather(et_hat, 1, choice[:, None, None].expand(b, 1, h))[:, 0, 0]
    return k_plan, ok.any(dim=-1), et_hat[:, 0, 0], et_plan, need
