"""Plain PyTorch version of the SSD scan kernel: the math of
``repro/kernels/ssd_scan/ref.py:ssd_chunk``, chunk after chunk with a
float32 state, in a form that stays finite over the whole decay range.

Per chunk of C steps, with ``pc`` the inclusive cumulative log-decay
(one scalar per step and stream) and ``tot`` its last value:

    y_i   = (C_i e^{pc_i}) S_in + sum_{j<=i} e^{pc_i - pc_j} (C_i . B_j) x_j
    S_out = e^{tot} S_in + sum_j (B_j e^{tot - pc_j})^T x_j

The reference forms the intra-chunk weight as ``(C e^{pc}) . (B
e^{-pc})``; ``e^{-pc}`` overflows float32 once a chunk's decay passes
e^-88 (the model clamps log a at -6 per step, 64 steps reach -384).  Here
the weight is the segment sum ``e^{pc_i - pc_j}`` over j <= i, at most 1:
the same function up to rounding wherever the reference is finite.

Layout: any leading dims (``[BH]`` as in the TPU kernel, or ``[B, H]``),
then ``[S, D]``; ``a`` is ``[..., S]``.  B and C may be expanded views
(zamba2 shares them across heads).
"""

from __future__ import annotations

import torch

__all__ = ["ssd_chunk", "ssd_scan"]

#: The float32 bytes of one group's [..., G, C, C] pair-weight block:
#: :func:`ssd_scan` runs the chunks' own terms for as many chunks at once as
#: fit (the state recurrence stays one step per chunk), so a long scan costs
#: ~25 operations per group, not per chunk.
GROUP_BYTES = 1 << 28


def _chunk_terms(x, a, b, c):
    """The terms of chunks that do not depend on the entering state, in
    float32: x [..., C, Dh], a [..., C], b / c [..., C, Dst] (leading dims
    may hold a chunk axis) -> (the intra-chunk output [..., C, Dh], C
    e^{pc} [..., C, Dst], e^{tot} [...], sum_j (B_j e^{tot - pc_j})^T x_j
    [..., Dst, Dh])."""
    f32 = torch.float32
    x, a, b, c = (t.to(f32) for t in (x, a, b, c))
    n = x.shape[-2]
    # The prefix sums of a as a masked sum over the pairs j <= i: not
    # ``torch.cumsum``, which has no deterministic CUDA implementation, nor
    # a product with triangular ones, which rounds a to TF32 where float32
    # products may use it.
    incl = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
    pc = torch.where(incl, a[..., None, :], 0.0).sum(-1)  # [..., C]
    tot = pc[..., -1]
    seg = torch.where(incl, pc[..., :, None] - pc[..., None, :],
                      torch.tensor(-torch.inf, device=x.device))
    att = (c @ b.transpose(-1, -2)) * torch.exp(seg)  # [..., C, C]
    b_dec = b * torch.exp(tot[..., None] - pc)[..., None]
    return (att @ x, c * torch.exp(pc)[..., None], torch.exp(tot),
            b_dec.transpose(-1, -2) @ x)


def ssd_chunk(x, a, b, c, state):
    """One chunk in float32: x [..., C, Dh], a [..., C], b / c [..., C,
    Dst], state [..., Dst, Dh] -> (y [..., C, Dh], new state)."""
    intra, c_dec, decay, bx = _chunk_terms(x, a, b, c)
    state = state.to(torch.float32)
    return c_dec @ state + intra, decay[..., None, None] * state + bx


def ssd_scan(x, a, b, c, s0=None, *, chunk: int = 64):
    """x [..., S, Dh], a [..., S] (log-decay, <= 0), b / c [..., S, Dst],
    s0 [..., Dst, Dh] or None (zeros) -> (y [..., S, Dh] in x's dtype, S_T
    float32).  The last chunk may be shorter than ``chunk``: it is padded
    with x = b = c = 0 and a = 0 (no decay), which add exact zeros to the
    state, and the padded rows are dropped."""
    if chunk < 1:
        raise ValueError(f"ssd_scan: chunk must be >= 1, got {chunk}")
    lead, s, dh, dst = x.shape[:-2], x.shape[-2], x.shape[-1], b.shape[-1]
    state = (torch.zeros((*lead, dst, dh), dtype=torch.float32, device=x.device) if s0 is None
             else s0.to(torch.float32))
    if s == 0:
        return x.new_zeros((*lead, 0, dh)), state
    n = -(-s // chunk)
    pad = n * chunk - s

    def chunks(t):  # [..., S, D] -> [..., n, C, D]
        if pad:
            t = torch.nn.functional.pad(t, (0, 0, 0, pad))
        return t.reshape(*t.shape[:-2], n, chunk, t.shape[-1])

    x, b, c, a = (*(chunks(t) for t in (x, b, c)), chunks(a[..., None])[..., 0])
    group = max(1, GROUP_BYTES // (4 * chunk * chunk * max(1, lead.numel())))
    ys = []
    for xg, bg, cg, ag in zip(*(t.split(group, dim=-3) for t in (x, b, c)),
                              a.split(group, dim=-2)):
        intra, c_dec, decay, bx = _chunk_terms(xg, ag, bg, cg)
        entering = []
        for decay_c, bx_c in zip(decay.unbind(-1), bx.unbind(-3)):
            entering.append(state)
            state = decay_c[..., None, None] * state + bx_c
        ys.append(c_dec @ torch.stack(entering, dim=-3) + intra)
    y = torch.cat(ys, dim=-3).reshape(*lead, n * chunk, dh)[..., :s, :]
    return y.to(x.dtype), state
