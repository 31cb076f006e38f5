"""Serving paths of the dense family: cache init, prefill and single-token
decode (the port of ``repro/models/serve.py``).

The cache is the reference's dict: ``k`` / ``v`` [L, B, S_max, Hkv, Dh]
and ``length``, a 0-dim int32 tensor on the device.  Unlike the
reference's pure functions, :func:`prefill` and :func:`decode_step` write
the new keys and values into the cache tensors in place (a decode step
would otherwise copy the whole cache) and return a new dict with the new
``length``.  The decode write position and the attention kernel's length
both come from that device tensor, so a step makes no host sync.  Other
families raise ``NotImplementedError`` (ROADMAP Queue 1 item 11b).
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from .attention import attention_decode, init_kv_cache
from .common import ModelConfig, apply_rope, rms_norm
from .transformer import (
    _attn_block,
    _ffn_block,
    attention_window,
    layer_params,
    lm_head,
    require_dense,
)

__all__ = ["init_cache", "prefill", "decode_step"]

Cache = dict


def init_cache(cfg: ModelConfig, batch: int, s_max: int, *, device=None) -> Cache:
    """An empty cache for ``batch`` sequences of up to ``s_max`` tokens on
    ``device`` (default: the CUDA device)."""
    require_dense(cfg)
    return init_kv_cache(cfg, batch, s_max, device=resolve_device(device))._asdict()


@torch.no_grad()
def prefill(params: dict, cfg: ModelConfig, batch: dict, cache: Cache, *, device=None
            ) -> tuple[torch.Tensor, Cache]:
    """Process the prompts ``batch["tokens"]`` [B, S]; fill the cache's
    first S positions (in place); return the last position's logits [B, V]
    and the cache at length S.  Runs on ``device`` (default: the CUDA
    device), where the parameters and the cache must be."""
    require_dense(cfg)
    dev = resolve_device(device)
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    b, s = tokens.shape
    x = params["embed"][tokens].to(cfg.dtype)
    positions = torch.arange(s, device=dev)[None].expand(b, s)
    window = attention_window(cfg)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        x, (k, v) = _attn_block(lp, x, cfg, positions, window=window)
        x = _ffn_block(lp, x, cfg)
        cache["k"][i, :, :s] = k.to(cfg.dtype)
        cache["v"][i, :, :s] = v.to(cfg.dtype)
    length = torch.full((), s, dtype=torch.int32, device=dev)
    return lm_head(params, cfg, x[:, -1:])[:, 0], {**cache, "length": length}


@torch.no_grad()
def decode_step(params: dict, cfg: ModelConfig, tokens, cache: Cache, *, device=None
                ) -> tuple[torch.Tensor, Cache]:
    """tokens [B] -> (logits [B, V], the cache one token longer).  The new
    keys and values go to position ``cache["length"]`` of every layer, in
    place."""
    require_dense(cfg)
    dev = resolve_device(device)
    tokens = torch.as_tensor(tokens, device=dev)
    b = tokens.shape[0]
    x = params["embed"][tokens][:, None].to(cfg.dtype)  # [B, 1, D]
    length = cache["length"]
    positions = length.reshape(1, 1).expand(b, 1)
    slot = length.reshape(1).to(torch.int64)
    new_length = length + 1
    window = attention_window(cfg)
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h2 = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q = (h2 @ lp["wq"]).reshape(b, 1, hq, dh)
        k = (h2 @ lp["wk"]).reshape(b, 1, hkv, dh)
        v = (h2 @ lp["wv"]).reshape(b, 1, hkv, dh)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        k_row, v_row = cache["k"][i], cache["v"][i]
        k_row.index_copy_(1, slot, k.to(cfg.dtype))
        v_row.index_copy_(1, slot, v.to(cfg.dtype))
        o = attention_decode(q, k_row, v_row, new_length, window=window)
        x = x + o.reshape(b, 1, cfg.q_dim) @ lp["wo"]
        x = _ffn_block(lp, x, cfg)
    return lm_head(params, cfg, x)[:, 0], {**cache, "length": new_length}
