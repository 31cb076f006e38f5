"""Plain PyTorch versions of the bounded-queue fluid step and of the whole
control window built on it.

One discrete-time step of every (scenario, operator) queue lane:

    served   = min(q, cap_serve)             # drain the step-start backlog
    q1       = q - served
    space    = max(cap_queue - q1, 0)        # +inf lanes never shed (block /
    admitted = min(inflow, space)            #  unbounded queues)
    dropped  = inflow - admitted
    q_next   = q1 + admitted

Elementwise, so the lane axis carries scenarios x operators.  The dtype
follows ``q`` (float32 or float64).

:func:`queue_window` runs a window of such steps with the routing hop and
the window sums (the 15 outputs of ``repro.streaming.batchsim.window_step_fn``).
Its three reductions -- the routing product ``sum_i served_prev[b, i] *
routing[b, i, j]`` and the two per-scenario row sums -- are index-order
loops of elementwise multiplies and adds, so every device (and the CUDA
window kernel, ``csrc/queue_step.cu``) rounds them alike; a batched
product or ``.sum(dim=-1)`` fixes no order.
"""

from __future__ import annotations

import torch

__all__ = ["queue_step", "queue_window"]


def queue_step(q, inflow, cap_serve, cap_queue):
    """[M] lanes -> (q_next, served, dropped), each [M]."""
    served = torch.minimum(q, cap_serve)
    q1 = q - served
    space = torch.clamp_min(cap_queue - q1, 0.0)
    admitted = torch.minimum(inflow, space)
    return q1 + admitted, served, inflow - admitted


def _row_sum(x):
    """``x[..., 0] + x[..., 1] + ...`` left to right."""
    s = x[..., 0]
    for i in range(1, x.shape[-1]):
        s = s + x[..., i]
    return s


def _route(served_prev, routing):
    """``routed[b, j] = sum_i served_prev[b, i] * routing[b, i, j]``, each
    product rounded, summed in index order."""
    r = served_prev[:, 0, None] * routing[:, 0, :]
    for i in range(1, routing.shape[1]):
        r = r + served_prev[:, i, None] * routing[:, i, :]
    return r


def queue_window(q, served_prev, ext, warm, cap_serve, cap_queue, routing):
    """One control window: ``q, served_prev, cap_serve, cap_queue`` [B, N],
    ``ext`` [T, B, N] arrivals, ``warm`` [T] step weights (a tensor or a
    host sequence), ``routing`` [B, N, N].

    Returns the 15-tuple ``q, served_prev`` (state), the ungated window
    sums ``offered, served, dropped`` [B, N], ``ext_admitted,
    ext_offered`` [B], ``q_int, q_max`` [B, N], and the ``warm``-weighted
    sums ``offered, served, dropped, ext_admitted, ext_offered, q_int``
    (``acc + w * x``, the product and the sum rounded separately).
    """
    b, n = q.shape
    warm = torch.as_tensor(warm, dtype=q.dtype, device=q.device)
    zeros = torch.zeros_like(q)
    zb = torch.zeros(b, dtype=q.dtype, device=q.device)
    offered, served_sum, dropped = zeros.clone(), zeros.clone(), zeros.clone()
    ext_adm, ext_off = zb.clone(), zb.clone()
    q_int, q_max = zeros.clone(), zeros.clone()
    w_off, w_srv, w_drop = zeros.clone(), zeros.clone(), zeros.clone()
    w_ea, w_eo, w_qi = zb.clone(), zb.clone(), zeros.clone()
    for t in range(ext.shape[0]):
        ext_t = ext[t]
        w = warm[t]
        inflow = ext_t + _route(served_prev, routing)
        q, served, drop_t = queue_step(q, inflow, cap_serve, cap_queue)
        admitted = inflow - drop_t
        adm_frac = torch.where(inflow > 0, admitted / torch.clamp_min(inflow, 1e-300), 1.0)
        ext_adm_t = _row_sum(ext_t * adm_frac)
        ext_off_t = _row_sum(ext_t)
        offered.add_(inflow)
        served_sum.add_(served)
        dropped.add_(drop_t)
        ext_adm.add_(ext_adm_t)
        ext_off.add_(ext_off_t)
        q_int.add_(q)
        torch.maximum(q_max, q, out=q_max)
        w_off.add_(w * inflow)
        w_srv.add_(w * served)
        w_drop.add_(w * drop_t)
        w_ea.add_(w * ext_adm_t)
        w_eo.add_(w * ext_off_t)
        w_qi.add_(w * q)
        served_prev = served
    return (q, served_prev, offered, served_sum, dropped, ext_adm, ext_off,
            q_int, q_max, w_off, w_srv, w_drop, w_ea, w_eo, w_qi)
