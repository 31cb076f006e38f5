"""GQA attention for the dense family: prefill / training attention and
KV-cache decode (the port of ``repro/models/attention.py``).

Both go through the Hopper kernels -- ``attention_train`` through
``kernels/flash_attention`` (the reference's "TPU drop-in"), ``attention_decode``
through ``kernels/decode_attention`` -- and, for CPU tensors, through their
plain versions.  The reference's naive / chunked ``impl`` switch has no
meaning once a kernel runs the attention and is dropped.  Layouts are the
reference's: activations [B, S, H, Dh], the cache [B, S_max, Hkv, Dh] per
layer.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.decode_attention import ops as decode_ops
from ..kernels.flash_attention import ops as flash_ops
from .common import ModelConfig

__all__ = ["KVCache", "attention_train", "attention_decode", "init_kv_cache"]


class KVCache(NamedTuple):
    k: torch.Tensor  # [L, B, S_max, Hkv, Dh]
    v: torch.Tensor  # [L, B, S_max, Hkv, Dh]
    length: torch.Tensor  # [] int32 -- tokens currently filled


def attention_train(q, k, v, *, causal: bool = True, window: int | None = None):
    """q [B, S, Hq, Dh], k / v [B, Skv, Hkv, Dh] -> [B, S, Hq, Dh].

    The kernel takes the heads-first views (``transpose(1, 2)``, no copy)
    and writes its output as a contiguous [B, S, Hq, Dh] buffer."""
    o = flash_ops.attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                            causal=causal, window=window)
    return o.transpose(1, 2)


def attention_decode(q, k_cache, v_cache, length, *, window: int | None = None):
    """q [B, 1, Hq, Dh] against the cache [B, S_max, Hkv, Dh] with valid
    prefix ``length`` (a 0-dim int32 tensor) -> [B, 1, Hq, Dh]."""
    b, _, hq, dh = q.shape
    o = decode_ops.decode_attention(q[:, 0], k_cache, v_cache, length, window=window)
    return o.reshape(b, 1, hq, dh)


def init_kv_cache(cfg: ModelConfig, batch: int, s_max: int, *, device=None) -> KVCache:
    shape = (cfg.n_layers, batch, s_max, cfg.n_kv_heads, cfg.head_dim_)
    return KVCache(
        k=torch.zeros(shape, dtype=cfg.dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.dtype, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device),
    )
