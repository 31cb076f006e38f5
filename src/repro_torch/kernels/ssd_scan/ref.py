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


def ssd_chunk(x, a, b, c, state):
    """One chunk in float32: x [..., C, Dh], a [..., C], b / c [..., C,
    Dst], state [..., Dst, Dh] -> (y [..., C, Dh], new state)."""
    f32 = torch.float32
    x, a, b, c, state = (t.to(f32) for t in (x, a, b, c, state))
    n = x.shape[-2]
    pc = torch.cumsum(a, dim=-1)  # [..., C]
    tot = pc[..., -1]
    incl = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
    seg = torch.where(incl, pc[..., :, None] - pc[..., None, :],
                      torch.tensor(-torch.inf, device=x.device))
    att = (c @ b.transpose(-1, -2)) * torch.exp(seg)  # [..., C, C]
    y = (c * torch.exp(pc)[..., None]) @ state + att @ x
    b_dec = b * torch.exp(tot[..., None] - pc)[..., None]
    new_state = torch.exp(tot)[..., None, None] * state + b_dec.transpose(-1, -2) @ x
    return y, new_state


def ssd_scan(x, a, b, c, s0=None, *, chunk: int = 64):
    """x [..., S, Dh], a [..., S] (log-decay, <= 0), b / c [..., S, Dst],
    s0 [..., Dst, Dh] or None (zeros) -> (y [..., S, Dh] in x's dtype, S_T
    float32).  The last chunk may be shorter than ``chunk``."""
    if chunk < 1:
        raise ValueError(f"ssd_scan: chunk must be >= 1, got {chunk}")
    lead, s, dh, dst = x.shape[:-2], x.shape[-2], x.shape[-1], b.shape[-1]
    state = (torch.zeros((*lead, dst, dh), dtype=torch.float32, device=x.device) if s0 is None
             else s0.to(torch.float32))
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        y, state = ssd_chunk(x[..., sl, :], a[..., sl], b[..., sl, :], c[..., sl, :], state)
        ys.append(y)
    y = torch.cat(ys, dim=-2) if ys else x.new_zeros((*lead, 0, dh), dtype=torch.float32)
    return y.to(x.dtype), state
