"""Serving paths: cache init, prefill and single-token decode for the
dense, ssm and hybrid families (the port of ``repro/models/serve.py``).

Caches are the reference's dicts, with ``length`` a 0-dim int32 tensor on
the device:

  dense   ``k`` / ``v`` [L, B, S_max, Hkv, Dh];
  ssm     ``wkv`` [L, B, H, Dk, Dv] float32 and the token shifts
          ``tm_shift`` / ``cm_shift`` [L, B, D];
  hybrid  ``ssm`` [L, B, H, Dst, 64] float32 and the shared block's
          ``k`` / ``v`` [G, B, S_max, Hkv, Dh], one row per site.

Unlike the reference's pure functions, :func:`prefill` and
:func:`decode_step` write into the cache tensors in place (a decode step
would otherwise copy the whole cache) and return a new dict with the new
``length``.  The decode write position and the attention kernel's length
both come from that device tensor, so a step makes no host sync.  The moe,
vlm and audio families raise ``NotImplementedError`` (ROADMAP Queue 1 item
5).
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from .attention import attention_decode, init_kv_cache
from .common import ModelConfig, apply_rope, rms_norm
from .transformer import (
    _attn_block,
    _ffn_block,
    _mamba2_mixer,
    _rwkv_layers,
    _zamba_layers,
    attention_window,
    layer_params,
    lm_head,
    require_ported,
    shared_sites,
)

__all__ = ["init_cache", "prefill", "decode_step"]

Cache = dict


def init_cache(cfg: ModelConfig, batch: int, s_max: int, *, device=None) -> Cache:
    """An empty cache for ``batch`` sequences of up to ``s_max`` tokens on
    ``device`` (default: the CUDA device)."""
    require_ported(cfg)
    dev = resolve_device(device)
    if cfg.family == "dense":
        return init_kv_cache(cfg, batch, s_max, device=dev)._asdict()
    L, d, dt = cfg.n_layers, cfg.d_model, cfg.dtype
    length = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.family == "ssm":
        hd = d // cfg.n_heads
        return {
            "wkv": torch.zeros((L, batch, cfg.n_heads, hd, hd), dtype=torch.float32, device=dev),
            "tm_shift": torch.zeros((L, batch, d), dtype=dt, device=dev),
            "cm_shift": torch.zeros((L, batch, d), dtype=dt, device=dev),
            "length": length,
        }
    g = len(shared_sites(cfg))
    kv = (g, batch, s_max, cfg.n_kv_heads, cfg.head_dim_)
    return {
        "ssm": torch.zeros((L, batch, 2 * d // 64, cfg.ssm_state, 64), dtype=torch.float32,
                           device=dev),
        "k": torch.zeros(kv, dtype=dt, device=dev),
        "v": torch.zeros(kv, dtype=dt, device=dev),
        "length": length,
    }


@torch.no_grad()
def prefill(params: dict, cfg: ModelConfig, batch: dict, cache: Cache, *, device=None
            ) -> tuple[torch.Tensor, Cache]:
    """Process the prompts ``batch["tokens"]`` [B, S]; fill the cache's
    first S positions (in place); return the last position's logits [B, V]
    and the cache at length S.  Runs on ``device`` (default: the CUDA
    device), where the parameters and the cache must be."""
    require_ported(cfg)
    dev = resolve_device(device)
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    b, s = tokens.shape
    x = params["embed"][tokens].to(cfg.dtype)
    positions = torch.arange(s, device=dev)[None].expand(b, s)
    if cfg.family == "dense":
        window = attention_window(cfg)
        for i in range(cfg.n_layers):
            lp = layer_params(params, i)
            x, (k, v) = _attn_block(lp, x, cfg, positions, window=window)
            x = _ffn_block(lp, x, cfg)
            cache["k"][i, :, :s] = k.to(cfg.dtype)
            cache["v"][i, :, :s] = v.to(cfg.dtype)
    elif cfg.family == "ssm":
        # the reference's prefill starts from zero shifts and states
        for key in ("wkv", "tm_shift", "cm_shift"):
            cache[key].zero_()
        x = _rwkv_layers(params, x, cfg, cache)
    else:
        x = _zamba_layers(params, x, cfg, positions, cache)
    length = torch.full((), s, dtype=torch.int32, device=dev)
    return lm_head(params, cfg, x[:, -1:])[:, 0], {**cache, "length": length}


@torch.no_grad()
def decode_step(params: dict, cfg: ModelConfig, tokens, cache: Cache, *, device=None
                ) -> tuple[torch.Tensor, Cache]:
    """tokens [B] -> (logits [B, V], the cache one token longer).  The new
    keys and values go to position ``cache["length"]`` of every layer, in
    place."""
    require_ported(cfg)
    dev = resolve_device(device)
    tokens = torch.as_tensor(tokens, device=dev)
    b = tokens.shape[0]
    x = params["embed"][tokens][:, None].to(cfg.dtype)  # [B, 1, D]
    length = cache["length"]
    new_length = length + 1
    if cfg.family == "ssm":
        x = _rwkv_layers(params, x, cfg, cache)
        return lm_head(params, cfg, x)[:, 0], {**cache, "length": new_length}
    positions = length.reshape(1, 1).expand(b, 1)
    slot = length.reshape(1).to(torch.int64)
    if cfg.family == "dense":
        window = attention_window(cfg)
        for i in range(cfg.n_layers):
            lp = layer_params(params, i)
            x = _attn_decode(lp, x, cfg, positions, slot, new_length, cache["k"][i],
                             cache["v"][i], window)
            x = _ffn_block(lp, x, cfg)
    else:
        sp = layer_params(params, 0, "shared_attn")
        for g, (lo, hi) in enumerate(shared_sites(cfg)):
            for i in range(lo, hi):
                lp = layer_params(params, i)
                o, st = _mamba2_mixer(lp, rms_norm(x, lp["norm"], cfg.norm_eps), cfg,
                                      cache["ssm"][i])
                x = x + o
                cache["ssm"][i] = st
            x = _attn_decode(sp, x, cfg, positions, slot, new_length, cache["k"][g],
                             cache["v"][g], None)
            x = _ffn_block(sp, x, cfg)
    return lm_head(params, cfg, x)[:, 0], {**cache, "length": new_length}


def _attn_decode(lp: dict, x, cfg: ModelConfig, positions, slot, new_length, k_row, v_row,
                 window):
    """One token's pre-norm attention with a residual: its key and value go
    to position ``slot`` of the layer's (or site's) cache rows, in place,
    then it attends over the first ``new_length`` positions."""
    b = x.shape[0]
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    h2 = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = (h2 @ lp["wq"]).reshape(b, 1, hq, dh)
    k = (h2 @ lp["wk"]).reshape(b, 1, hkv, dh)
    v = (h2 @ lp["wv"]).reshape(b, 1, hkv, dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    k_row.index_copy_(1, slot, k.to(cfg.dtype))
    v_row.index_copy_(1, slot, v.to(cfg.dtype))
    o = attention_decode(q, k_row, v_row, new_length, window=window)
    return x + o.reshape(b, 1, cfg.q_dim) @ lp["wo"]
