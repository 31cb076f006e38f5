"""Per-operator arrival-rate forecasters over the measurement history
window, with online error tracking (the port's copy of
``repro/forecast/predictors.py``).

Every predictor is a pure batched function ``(history [B, W, N], horizon)
-> predicted rates [B, H, N]``.  The reference writes each one once against
an ``xp`` namespace; here each has two faces:

* the numpy face (``forecast_rates``, ``error_update``, ...) is the float64
  host twin the batched ``tick_batch`` and the live scheduler run -- the
  reference's float ops in its order, so the committed proactive golden
  replays bit for bit;
* the torch face (``forecast_rates_torch``, ...) runs the same ops on
  tensors, on their device, inside the fused control loop.

Kinds (:class:`PredictorParams`): ``ewma`` (simple exponential smoothing,
flat forecast), ``holt`` (level + trend, the trend extrapolated and clamped
at 0) and ``seasonal`` (seasonal-naive: the observation one season back at
the same phase).  :func:`confidence` collapses the tracked one-step MASE and
sMAPE into each scenario's trust gate: a closed gate hands the tick back to
the reactive decide.  State is a flat tuple of arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "PREDICTOR_KINDS",
    "PredictorParams",
    "forecast_rates",
    "error_init",
    "error_update",
    "mase",
    "smape",
    "confidence",
    "history_init",
    "history_push",
    "forecast_rates_torch",
    "error_init_torch",
    "error_update_torch",
    "mase_torch",
    "smape_torch",
    "confidence_torch",
    "history_init_torch",
    "history_push_torch",
]

PREDICTOR_KINDS = ("ewma", "holt", "seasonal")

# sMAPE denominator guard: a 0-rate observation met by a 0-rate forecast
# scores 0 error, not 0/0.
_SMAPE_EPS = 1e-9
# MASE denominator guard (a constant history has zero naive error).
_MASE_EPS = 1e-12


@dataclass(frozen=True)
class PredictorParams:
    """One predictor's knobs."""

    kind: str = "holt"
    alpha: float = 0.5  # level smoothing weight (newest observation)
    beta: float = 0.3  # trend smoothing weight (holt)
    season: int = 0  # season length in ticks (seasonal; >= 2)

    def __post_init__(self):
        if self.kind not in PREDICTOR_KINDS:
            raise ValueError(
                f"unknown predictor kind {self.kind!r}; expected one of "
                f"{PREDICTOR_KINDS}"
            )
        if not 0.0 < self.alpha <= 1.0 or not 0.0 <= self.beta <= 1.0:
            raise ValueError(
                f"need 0 < alpha <= 1 and 0 <= beta <= 1; got "
                f"alpha={self.alpha}, beta={self.beta}"
            )
        if self.kind == "seasonal" and self.season < 2:
            raise ValueError(
                f"seasonal predictor needs season >= 2 ticks, got {self.season}"
            )


def _seasonal_index(w: int, horizon: int, season: int) -> list[int]:
    """Window rows the seasonal-naive forecast reads, one per step."""
    if w < season:
        raise ValueError(f"seasonal window {w} shorter than season {season}")
    return [w - season + (h % season) for h in range(horizon)]


# --------------------------------------------------------------------------- #
# numpy face (the float64 twin)
# --------------------------------------------------------------------------- #
def _ewma_level(history, alpha: float):
    """[B, N] smoothed level after one pass over the window."""
    level = history[:, 0, :]
    for t in range(1, history.shape[1]):
        level = alpha * history[:, t, :] + (1.0 - alpha) * level
    return level


def _holt_state(history, alpha: float, beta: float, zeros_like=np.zeros_like):
    """[B, N] (level, trend) after one Holt pass over the window."""
    level = history[:, 0, :]
    trend = zeros_like(level)
    for t in range(1, history.shape[1]):
        y = history[:, t, :]
        new_level = alpha * y + (1.0 - alpha) * (level + trend)
        trend = beta * (new_level - level) + (1.0 - beta) * trend
        level = new_level
    return level, trend


def forecast_rates(history, horizon: int, params: PredictorParams):
    """``history [B, W, N]`` (oldest first) -> predicted rates ``[B, H, N]``;
    step h (0-based) targets tick ``now + h + 1``.  Negative extrapolations
    clamp to 0; the seasonal kind needs ``W >= season``."""
    b, w, n = history.shape
    if horizon < 1:
        raise ValueError(f"need horizon >= 1, got {horizon}")
    if params.kind == "ewma":
        level = _ewma_level(history, params.alpha)
        return np.broadcast_to(level[:, None, :], (b, horizon, n)) + np.zeros(
            (b, horizon, n), dtype=history.dtype
        )
    if params.kind == "holt":
        level, trend = _holt_state(history, params.alpha, params.beta)
        steps = np.arange(1, horizon + 1, dtype=history.dtype)
        return np.maximum(
            level[:, None, :] + steps[None, :, None] * trend[:, None, :], 0.0
        )
    idx = np.array(_seasonal_index(w, horizon, params.season), dtype=np.int64)
    return history[:, idx, :]


def error_init(b: int, n: int, dtype=np.float64):
    """Zeroed tracker state: ``(prev_pred [B,N], prev_y [B,N], abs_err_sum
    [B,N], naive_err_sum [B,N], smape_sum [B,N], n_obs [B])``."""
    z = np.zeros((b, n), dtype=dtype)
    return (z, z, z, z, z, np.zeros(b, dtype=dtype))


def error_update(state, pred_next, y):
    """Score last tick's one-step forecast against the observed ``y [B, N]``
    (once a prior prediction exists), then arm ``pred_next``."""
    prev_pred, prev_y, abs_err, naive_err, smape_sum, n_obs = state
    scored = np.where(n_obs >= 1.0, 1.0, 0.0)[:, None]
    err = np.abs(prev_pred - y)
    naive = np.abs(y - prev_y)
    sm = 2.0 * err / (np.abs(prev_pred) + np.abs(y) + _SMAPE_EPS)
    return (
        pred_next,
        y,
        abs_err + scored * err,
        naive_err + scored * naive,
        smape_sum + scored * sm,
        n_obs + 1.0,
    )


def mase(state):
    """[B, N] mean absolute error scaled by the persistence forecast's."""
    return state[2] / np.maximum(state[3], _MASE_EPS)


def smape(state):
    """[B, N] symmetric MAPE of the one-step forecasts, in [0, 2]."""
    scored = np.maximum(state[5] - 1.0, 1.0)[:, None]
    return state[4] / scored


def confidence(state, active, *, min_scored: int, mase_gate: float, smape_gate: float):
    """[B] bool: at least ``min_scored`` scored comparisons and the
    active-lane mean MASE / sMAPE under their gates."""
    m = mase(state)
    s = smape(state)
    act = np.where(active, 1.0, 0.0)
    cnt = np.maximum(act.sum(axis=-1), 1.0)
    m_mean = (act * m).sum(axis=-1) / cnt
    s_mean = (act * s).sum(axis=-1) / cnt
    scored = state[5] - 1.0
    return (scored >= float(min_scored)) & (m_mean <= mase_gate) & (s_mean <= smape_gate)


def history_init(b: int, w: int, n: int, dtype=np.float64):
    """Zeroed ``[B, W, N]`` rate-history window (oldest first)."""
    return np.zeros((b, w, n), dtype=dtype)


def history_push(hist, y, n_obs):
    """Append ``y [B, N]``; the very first observation (``n_obs < 1``)
    back-fills the whole window, so the smoothing starts from the first
    real rate instead of a ramp from 0."""
    rolled = np.concatenate([hist[:, 1:, :], y[:, None, :]], axis=1)
    filled = np.broadcast_to(y[:, None, :], hist.shape)
    first = (n_obs < 1.0)[:, None, None]
    return np.where(first, filled, rolled)


# --------------------------------------------------------------------------- #
# torch face (the fused loop; tensors on their device, in their dtype)
# --------------------------------------------------------------------------- #
def forecast_rates_torch(history, horizon: int, params: PredictorParams):
    """:func:`forecast_rates` on a ``[B, W, N]`` tensor."""
    b, w, n = history.shape
    if horizon < 1:
        raise ValueError(f"need horizon >= 1, got {horizon}")
    if params.kind == "ewma":
        level = _ewma_level(history, params.alpha)
        return level[:, None, :].expand(b, horizon, n) + torch.zeros_like(
            history[:, :1, :]).expand(b, horizon, n)
    if params.kind == "holt":
        level, trend = _holt_state(history, params.alpha, params.beta,
                                   zeros_like=torch.zeros_like)
        steps = torch.arange(1, horizon + 1, dtype=history.dtype, device=history.device)
        return torch.clamp_min(level[:, None, :] + steps[None, :, None] * trend[:, None, :],
                               0.0)
    return history[:, _seasonal_index(w, horizon, params.season), :]


def error_init_torch(b: int, n: int, *, dtype, device):
    """:func:`error_init` as tensors (each leaf its own buffer)."""
    return tuple(torch.zeros((b, n), dtype=dtype, device=device) for _ in range(5)) + (
        torch.zeros(b, dtype=dtype, device=device),)


def error_update_torch(state, pred_next, y):
    """:func:`error_update` on tensors."""
    prev_pred, prev_y, abs_err, naive_err, smape_sum, n_obs = state
    scored = (n_obs >= 1.0).to(y.dtype)[:, None]
    err = torch.abs(prev_pred - y)
    naive = torch.abs(y - prev_y)
    sm = 2.0 * err / (torch.abs(prev_pred) + torch.abs(y) + _SMAPE_EPS)
    return (
        pred_next,
        y,
        abs_err + scored * err,
        naive_err + scored * naive,
        smape_sum + scored * sm,
        n_obs + 1.0,
    )


def mase_torch(state):
    return state[2] / torch.clamp_min(state[3], _MASE_EPS)


def smape_torch(state):
    scored = torch.clamp_min(state[5] - 1.0, 1.0)[:, None]
    return state[4] / scored


def confidence_torch(state, active, *, min_scored: int, mase_gate: float,
                     smape_gate: float):
    """:func:`confidence` on tensors."""
    m = mase_torch(state)
    s = smape_torch(state)
    act = active.to(m.dtype)
    cnt = torch.clamp_min(act.sum(dim=-1), 1.0)
    m_mean = (act * m).sum(dim=-1) / cnt
    s_mean = (act * s).sum(dim=-1) / cnt
    scored = state[5] - 1.0
    return (scored >= float(min_scored)) & (m_mean <= mase_gate) & (s_mean <= smape_gate)


def history_init_torch(b: int, w: int, n: int, *, dtype, device):
    return torch.zeros((b, w, n), dtype=dtype, device=device)


def history_push_torch(hist, y, n_obs):
    """:func:`history_push` on tensors."""
    rolled = torch.cat([hist[:, 1:, :], y[:, None, :]], dim=1)
    filled = y[:, None, :].expand(hist.shape)
    first = (n_obs < 1.0)[:, None, None]
    return torch.where(first, filled, rolled)
