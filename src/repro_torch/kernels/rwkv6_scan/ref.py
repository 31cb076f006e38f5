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

#: The float32 bytes of one group's [..., G, C, C, Dk] pair-decay block:
#: :func:`rwkv6_scan` runs the chunks' own terms for as many chunks at once
#: as fit (the state recurrence stays one step per chunk), so a long scan
#: costs ~30 operations per group, not per chunk.
GROUP_BYTES = 1 << 28


def _chunk_terms(r, k, v, lw, u):
    """The terms of chunks that do not depend on the entering state, in
    float32: r / k / lw [..., C, Dk], v [..., C, Dv], u broadcastable to
    [..., Dk] (leading dims may hold a chunk axis) -> (the intra-chunk
    output [..., C, Dv], r e^{pc_prev} [..., C, Dk], e^{tot} [..., Dk],
    sum_j (k_j e^{tot - pc_j})^T v_j [..., Dk, Dv])."""
    f32 = torch.float32
    r, k, v, lw, u = (t.to(f32) for t in (r, k, v, lw, u))
    c = r.shape[-2]
    # The prefix sums of lw as a masked sum over the pairs j <= i: not
    # ``torch.cumsum``, which has no deterministic CUDA implementation, nor
    # a product with triangular ones, which rounds lw to TF32 where float32
    # products may use it.
    ones = torch.ones(c, c, dtype=torch.bool, device=r.device)
    pc = torch.where(ones.tril()[..., None], lw[..., None, :, :], 0.0).sum(-2)
    pc_prev = torch.cat([torch.zeros_like(pc[..., :1, :]), pc[..., :-1, :]], dim=-2)
    tot = pc[..., -1, :]
    strict = ones.tril(-1)[..., None]
    expo = pc_prev[..., :, None, :] - pc[..., None, :, :]  # [..., C, C, Dk]
    decay = torch.exp(torch.where(strict, expo, torch.tensor(-torch.inf, device=r.device)))
    att = ((r[..., :, None, :] * k[..., None, :, :]) * decay).sum(-1)  # [..., C, C]
    diag = (r * u[..., None, :] * k).sum(-1)
    intra = att @ v + diag[..., None] * v
    k_dec = k * torch.exp(tot[..., None, :] - pc)
    return intra, r * torch.exp(pc_prev), torch.exp(tot), k_dec.transpose(-1, -2) @ v


def rwkv6_chunk(r, k, v, lw, u, state):
    """One chunk in float32: r / k / lw [..., C, Dk], v [..., C, Dv], u
    [..., Dk], state [..., Dk, Dv] -> (out [..., C, Dv], new state)."""
    intra, r_dec, decay, kv = _chunk_terms(r, k, v, lw, u)
    state = state.to(torch.float32)
    return r_dec @ state + intra, decay[..., :, None] * state + kv


def rwkv6_scan(r, k, v, lw, u, s0=None, *, chunk: int = 32):
    """r / k / lw [..., S, Dk], v [..., S, Dv], u [..., Dk], s0 [..., Dk,
    Dv] or None (zeros) -> (o [..., S, Dv] in r's dtype, S_T float32).
    The last chunk may be shorter than ``chunk``: it is padded with
    r = k = v = 0 and lw = 0 (no decay), which add exact zeros to the
    state, and the padded rows are dropped."""
    if chunk < 1:
        raise ValueError(f"rwkv6_scan: chunk must be >= 1, got {chunk}")
    lead, s, dk, dv = r.shape[:-2], r.shape[-2], r.shape[-1], v.shape[-1]
    state = (torch.zeros((*lead, dk, dv), dtype=torch.float32, device=r.device) if s0 is None
             else s0.to(torch.float32))
    if s == 0:
        return v.new_zeros((*lead, 0, dv), dtype=r.dtype), state
    n = -(-s // chunk)
    pad = n * chunk - s

    def chunks(t):  # [..., S, D] -> [..., n, C, D]
        if pad:
            t = torch.nn.functional.pad(t, (0, 0, 0, pad))
        return t.reshape(*t.shape[:-2], n, chunk, t.shape[-1])

    r, k, v, lw = (chunks(t) for t in (r, k, v, lw))
    u = u[..., None, :]  # broadcasts over the chunk axis
    group = max(1, GROUP_BYTES // (4 * chunk * chunk * dk * max(1, lead.numel())))
    outs = []
    for rg, kg, vg, lg in zip(*(t.split(group, dim=-3) for t in (r, k, v, lw))):
        intra, r_dec, decay, kv = _chunk_terms(rg, kg, vg, lg, u)
        entering = []
        for decay_c, kv_c in zip(decay.unbind(-2), kv.unbind(-3)):
            entering.append(state)
            state = decay_c[..., :, None] * state + kv_c
        outs.append(r_dec @ torch.stack(entering, dim=-3) + intra)
    out = torch.cat(outs, dim=-3).reshape(*lead, n * chunk, dv)[..., :s, :]
    return out.to(r.dtype), state
