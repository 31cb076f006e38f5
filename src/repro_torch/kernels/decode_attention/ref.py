"""Plain PyTorch version of the decode attention kernel: the same math as
``repro/kernels/decode_attention/ref.py``, op for op.

q [B, H, Dh] (one new token per sequence), caches [B, S, Hkv, Dh] with
``Hkv`` dividing ``H`` (query head ``h`` reads KV head ``h // (H // Hkv)``),
``length`` the valid prefix: an int, or an integer tensor of shape [] or
[B] (one length per sequence), broadcast to [B] as the JAX oracle does.
Positions ``>= length`` -- and, with a window, ``<= length - 1 - window``
-- are masked with ``-1e30``.  This version expands the KV heads with a
repeat; the CUDA kernel reads the shared head in place.
"""

from __future__ import annotations

import torch

from ..flash_attention.ref import repeat_kv_heads

__all__ = ["decode_attention"]


def decode_attention(q, k_cache, v_cache, length, *, window: int | None = None,
                     scale: float | None = None) -> torch.Tensor:
    h, dh = q.shape[1:]
    s = k_cache.shape[1]
    n_rep = h // k_cache.shape[2]
    k_cache = repeat_kv_heads(k_cache, n_rep, 2)
    v_cache = repeat_kv_heads(v_cache, n_rep, 2)
    scale = scale if scale is not None else 1.0 / (dh ** 0.5)
    logits = torch.einsum(
        "bhd,bshd->bhs", q.to(torch.float32), k_cache.to(torch.float32)) * scale
    pos = torch.arange(s, device=q.device)
    ln = torch.as_tensor(length, device=q.device).broadcast_to((q.shape[0],))
    valid = pos[None, :] < ln[:, None]  # [B, S]
    if window is not None:
        valid &= pos[None, :] > ln[:, None] - 1 - window
    logits = torch.where(valid[:, None, :], logits, torch.tensor(-1e30, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhs,bshd->bhd", probs, v_cache.to(torch.float32)).to(q.dtype)
