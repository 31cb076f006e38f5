"""Plain PyTorch version of the RWKV6 scan kernel: the math of
``repro/kernels/rwkv6_scan/ref.py:rwkv6_chunk``, chunk after chunk with a
float32 state, in a form that stays finite over the whole decay range.

Per chunk of C tokens (positions i, j), with ``pc`` the inclusive and
``pc_prev`` the exclusive cumulative log-decay:

    out_i  = (r_i e^{pc_prev_i}) S_in
           + sum_{j<i} [sum_k r_ik k_jk e^{pc_prev_ik - pc_jk}] v_j
           + [(r_i * u) . k_i] v_i
    S_out  = e^{tot} S_in + sum_j (k_j e^{tot - pc_j})^T v_j

The reference forms the intra-chunk weight as ``(r e^{pc_prev}) . (k
e^{-pc})``; ``e^{-pc}`` overflows float32 once a chunk's decay passes
e^-88 (at the model's floor w = 0.05 a chunk of 32 reaches e^-96).  Here
every exponent is a difference ``pc_prev_i - pc_j`` over the pairs j < i
only, at most 0, so the weight is at most 1: the same function up to
rounding wherever the reference is finite, and finite everywhere else.

Layout: any leading dims (``[BH]`` as in the TPU kernel, or ``[B, H]``),
then ``[S, D]``.  ``u`` broadcasts against the leading dims (one bonus
per stream, e.g. ``[H, Dk]`` for ``[B, H]`` streams).
"""

from __future__ import annotations

import torch

__all__ = ["rwkv6_chunk", "rwkv6_scan"]


def rwkv6_chunk(r, k, v, lw, u, state):
    """One chunk in float32: r / k / lw [..., C, Dk], v [..., C, Dv], u
    [..., Dk], state [..., Dk, Dv] -> (out [..., C, Dv], new state)."""
    f32 = torch.float32
    r, k, v, lw, u, state = (t.to(f32) for t in (r, k, v, lw, u, state))
    c = r.shape[-2]
    pc = torch.cumsum(lw, dim=-2)
    pc_prev = torch.cat([torch.zeros_like(pc[..., :1, :]), pc[..., :-1, :]], dim=-2)
    tot = pc[..., -1, :]
    cross = (r * torch.exp(pc_prev)) @ state
    strict = torch.ones(c, c, dtype=torch.bool, device=r.device).tril(-1)[..., None]
    expo = pc_prev[..., :, None, :] - pc[..., None, :, :]  # [..., C, C, Dk]
    decay = torch.exp(torch.where(strict, expo, torch.tensor(-torch.inf, device=r.device)))
    att = ((r[..., :, None, :] * k[..., None, :, :]) * decay).sum(-1)  # [..., C, C]
    diag = (r * u[..., None, :] * k).sum(-1)
    out = cross + att @ v + diag[..., None] * v
    k_dec = k * torch.exp(tot[..., None, :] - pc)
    new_state = torch.exp(tot)[..., :, None] * state + k_dec.transpose(-1, -2) @ v
    return out, new_state


def rwkv6_scan(r, k, v, lw, u, s0=None, *, chunk: int = 32):
    """r / k / lw [..., S, Dk], v [..., S, Dv], u [..., Dk], s0 [..., Dk,
    Dv] or None (zeros) -> (o [..., S, Dv] in r's dtype, S_T float32).
    The last chunk may be shorter than ``chunk``."""
    if chunk < 1:
        raise ValueError(f"rwkv6_scan: chunk must be >= 1, got {chunk}")
    lead, s, dk, dv = r.shape[:-2], r.shape[-2], r.shape[-1], v.shape[-1]
    state = (torch.zeros((*lead, dk, dv), dtype=torch.float32, device=r.device) if s0 is None
             else s0.to(torch.float32))
    outs = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        o, state = rwkv6_chunk(r[..., sl, :], k[..., sl, :], v[..., sl, :], lw[..., sl, :], u,
                               state)
        outs.append(o)
    out = torch.cat(outs, dim=-2) if outs else v.new_zeros((*lead, 0, dv), dtype=torch.float32)
    return out.to(r.dtype), state
