"""Plain PyTorch version of the flash attention kernel: the same math as
``repro/kernels/flash_attention/ref.py``, op for op (float32 logits,
``-1e30`` masking, softmax, float32 product, cast back).

Heads-first layout: q [B, H, Sq, Dh], k / v [B, Hkv, Skv, Dh] with ``Hkv``
dividing ``H``; query head ``h`` reads KV head ``h // (H // Hkv)``.  This
version expands the KV heads with a repeat (the CUDA kernel indexes the
shared head instead).
"""

from __future__ import annotations

import torch

__all__ = ["attention", "repeat_kv_heads"]


def repeat_kv_heads(x: torch.Tensor, n_rep: int, dim: int) -> torch.Tensor:
    """Expand ``Hkv`` heads on axis ``dim`` to ``Hkv * n_rep`` (GQA)."""
    return x if n_rep == 1 else torch.repeat_interleave(x, n_rep, dim=dim)


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              scale: float | None = None) -> torch.Tensor:
    b, h, sq, dh = q.shape
    skv = k.shape[2]
    n_rep = h // k.shape[1]
    k = repeat_kv_heads(k, n_rep, 1)
    v = repeat_kv_heads(v, n_rep, 1)
    scale = scale if scale is not None else 1.0 / (dh ** 0.5)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), k.to(torch.float32))
    logits = logits * scale
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        k_pos = torch.arange(skv, device=q.device)[None, :]
        mask = k_pos <= q_pos
        if window is not None:
            mask &= k_pos > q_pos - window
        logits = torch.where(mask[None, None], logits, torch.tensor(-1e30, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.to(torch.float32)).to(q.dtype)
