"""Plain PyTorch version of the grouped experts' kernels
(``csrc/moe_experts.cu``): each expert's SwiGLU on the rows of its counted
row tiles, rounded where ``models/ffn.py:_experts`` rounds -- the gate and
up products in the buffer's dtype, the gate's silu in float32 rounded back,
their product in the buffer's dtype, then the Wo product.  Rows of the
tiles not run are zero (the kernels leave them unwritten)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernel import run_rows

__all__ = ["experts"]


def experts(buf, wg, wu, wo, counts) -> torch.Tensor:
    """buf [E, C, D], wg / wu [E, D, F], wo [E, F, D], counts [E] -> [E, C, D]."""
    out = torch.zeros_like(buf)
    for i, n in enumerate(run_rows(counts, buf.shape[1]).tolist()):
        x = buf[i, :n]
        h = F.silu((x @ wg[i]).to(torch.float32)).to(buf.dtype) * (x @ wu[i])
        out[i, :n] = h @ wo[i]
    return out
