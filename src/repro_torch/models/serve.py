"""Serving paths: cache init, prefill and single-token decode for the
dense, moe, vlm, ssm, hybrid and audio families (the port of
``repro/models/serve.py``).

Caches are the reference's dicts, with ``length`` a 0-dim int32 tensor on
the device:

  dense, moe, vlm  ``k`` / ``v`` [L, B, S_max, Hkv, Dh] (vlm: the patches
          fill the first positions);
  ssm     ``wkv`` [L, B, H, Dk, Dv] float32 and the token shifts
          ``tm_shift`` / ``cm_shift`` [L, B, D];
  hybrid  ``ssm`` [L, B, H, Dst, 64] float32 and the shared block's
          ``k`` / ``v`` [G, B, S_max, Hkv, Dh], one row per site;
  audio   the decoder's self ``k`` / ``v`` [L, B, S_max, Hkv, Dh] and the
          cross ``xk`` / ``xv`` [L, B, S_enc, Hkv, Dh] that the prefill
          computes once from the encoder's output.

Unlike the reference's pure functions, :func:`prefill` and
:func:`decode_step` write into the cache tensors in place (a decode step
would otherwise copy the whole cache) and return a new dict with the new
``length``.  The decode write position and the attention kernel's length
both come from that device tensor, so a step makes no host sync.  The MoE
layers' aux losses are discarded, as the reference discards them; their
capacity counts the tokens of each call, so a B = 4 decode step has one
slot per expert (mixtral-8x22b, kimi-k2-1t-a32b) and drops are part of the
semantics.  The vlm decode rotates with all three M-RoPE streams at
``length``, as the reference does.  Whisper's prefill runs the encoder
over ``batch["frames"]`` and sizes the cross cache to the frames' count
(the reference replaces ``xk`` / ``xv`` with the prefill's), while its
decode step attends over ``cfg.enc_seq`` cross rows, as the reference's
``attention_decode(q, xk, xv, enc_seq)`` does: with fewer frames every
row counts, with more the rows past ``enc_seq`` are left out of decode
but not of the prefill.
"""

from __future__ import annotations

import torch

from .. import obs
from ..device import resolve_device
from .attention import attention_decode, init_kv_cache
from .common import ModelConfig, rms_norm
from .transformer import (
    DECODER_FAMILIES,
    _ffn_block,
    _gelu_mlp,
    _heads,
    _mamba2_mixer,
    _qkv,
    _rwkv_layers,
    _zamba_layers,
    attention_window,
    decoder_layers,
    embed_inputs,
    layer_params,
    lm_head,
    require_ported,
    shared_sites,
    whisper_decoder,
    whisper_encoder,
    whisper_layer,
)

__all__ = ["init_cache", "prefill", "decode_step"]

Cache = dict


def init_cache(cfg: ModelConfig, batch: int, s_max: int, *, device=None) -> Cache:
    """An empty cache for ``batch`` sequences of up to ``s_max`` tokens on
    ``device`` (default: the CUDA device)."""
    require_ported(cfg)
    dev = resolve_device(device)
    L, d, dt = cfg.n_layers, cfg.d_model, cfg.dtype
    if cfg.family in DECODER_FAMILIES or cfg.family == "audio":
        cache = init_kv_cache(cfg, batch, s_max, device=dev)._asdict()
        if cfg.family == "audio":  # the cross keys and values, a row per frame
            cross = (L, batch, cfg.enc_seq, cfg.n_kv_heads, cfg.head_dim_)
            cache.update(xk=torch.zeros(cross, dtype=dt, device=dev),
                         xv=torch.zeros(cross, dtype=dt, device=dev))
        return cache
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
def prefill(params: dict, cfg: ModelConfig, batch: dict, cache: Cache, *, device=None,
            routing: list | None = None) -> tuple[torch.Tensor, Cache]:
    """Process the prompts ``batch["tokens"]`` [B, S] (vlm: after the
    patches ``batch["patch_embeds"]`` [B, P, D], rotated by
    ``batch["positions_3d"]`` [3, B, P + S] when given; audio: with the
    encoder over ``batch["frames"]`` [B, S_enc, D], whose cross keys and
    values fill ``xk`` / ``xv`` -- in place when the cache holds S_enc
    rows, else in new tensors of S_enc rows, as the reference sizes them);
    fill the cache's first S (P + S) positions (in place); return the last
    position's logits [B, V] and the cache at that length.  Runs on
    ``device`` (default: the CUDA device), where the parameters and the
    cache must be.  ``routing`` (a list) receives each MoE layer's routing
    (``models/ffn.py``).  Recorded as the span ``serve.prefill``
    (:mod:`repro_torch.obs`)."""
    with obs.call("serve.prefill", device):
        return _prefill(params, cfg, batch, cache, device, routing)


def _prefill(params: dict, cfg: ModelConfig, batch: dict, cache: Cache, device, routing):
    require_ported(cfg)
    dev = resolve_device(device)
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    x, positions = embed_inputs(params, cfg, batch, tokens)
    s = x.shape[1]
    if cfg.family in DECODER_FAMILIES:
        p3 = batch.get("positions_3d")
        p3 = None if p3 is None else torch.as_tensor(p3, device=dev)
        x, _aux = decoder_layers(params, x, cfg, positions, p3, routing=routing, cache=cache)
    elif cfg.family == "ssm":
        # the reference's prefill starts from zero shifts and states
        for key in ("wkv", "tm_shift", "cm_shift"):
            cache[key].zero_()
        x = _rwkv_layers(params, x, cfg, cache)
    elif cfg.family == "hybrid":
        x = _zamba_layers(params, x, cfg, positions, cache)
    else:
        frames = torch.as_tensor(batch["frames"], device=dev).to(cfg.dtype)
        enc = whisper_encoder(params, frames, cfg)
        cross = (*cache["xk"].shape[:2], enc.shape[1], *cache["xk"].shape[3:])
        if tuple(cache["xk"].shape) != cross:
            cache = {**cache, "xk": cache["xk"].new_empty(cross),
                     "xv": cache["xv"].new_empty(cross)}
        x = whisper_decoder(params, x, enc, cfg, positions, cache)
    length = torch.full((), s, dtype=torch.int32, device=dev)
    return lm_head(params, cfg, x[:, -1:])[:, 0], {**cache, "length": length}


@torch.no_grad()
def decode_step(params: dict, cfg: ModelConfig, tokens, cache: Cache, *, device=None,
                routing: list | None = None) -> tuple[torch.Tensor, Cache]:
    """tokens [B] -> (logits [B, V], the cache one token longer).  The new
    keys and values go to position ``cache["length"]`` of every layer (or
    site), in place -- on a full cache (``length == S_max``) to its last
    row, where the reference's ``dynamic_update_slice`` clamps them;
    whisper's cross attention reads the first ``cfg.enc_seq`` rows of ``xk``
    / ``xv`` (a length made on the device once per step).
    ``routing``: as :func:`prefill`'s.  Recorded as the span
    ``serve.decode_step`` (:mod:`repro_torch.obs`)."""
    with obs.call("serve.decode_step", device):
        return _decode_step(params, cfg, tokens, cache, device, routing)


def _decode_step(params: dict, cfg: ModelConfig, tokens, cache: Cache, device, routing):
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
    # the write position: ``length`` clamped to the last row on the device,
    # as ``dynamic_update_slice`` clamps its start (a full cache overwrites
    # its last row)
    slot = torch.clamp(length, max=cache["k"].shape[2] - 1).reshape(1).to(torch.int64)
    if cfg.family in DECODER_FAMILIES:
        window = attention_window(cfg)
        p3 = length.reshape(1, 1, 1).expand(3, b, 1) if cfg.m_rope else None
        for i in range(cfg.n_layers):
            lp = layer_params(params, i)
            x = _attn_decode(lp, x, cfg, positions, slot, new_length, cache["k"][i],
                             cache["v"][i], window, p3)
            x = _ffn_block(lp, x, cfg, routing=routing)[0]
    elif cfg.family == "audio":
        enc_len = torch.full((), cfg.enc_seq, dtype=torch.int32, device=dev)
        for i in range(cfg.n_layers):
            lp = whisper_layer(params, i, "dec")
            x = _attn_decode(lp, x, cfg, positions, slot, new_length, cache["k"][i],
                             cache["v"][i], None)
            q = _heads(rms_norm(x, lp["xattn_norm"], cfg.norm_eps) @ lp["xq"], cfg.n_heads, cfg)
            o = attention_decode(q, cache["xk"][i], cache["xv"][i], enc_len)
            x = x + o.reshape(b, 1, cfg.q_dim) @ lp["xo"]
            x = _gelu_mlp(lp, x, cfg)
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
            x = _ffn_block(sp, x, cfg)[0]
    return lm_head(params, cfg, x)[:, 0], {**cache, "length": new_length}


def _attn_decode(lp: dict, x, cfg: ModelConfig, positions, slot, new_length, k_row, v_row,
                 window, positions_3d=None):
    """One token's pre-norm attention with a residual: its key and value go
    to position ``slot`` of the layer's (or site's) cache rows, in place,
    then it attends over the first ``new_length`` positions."""
    b = x.shape[0]
    with obs.span("layer.attn"):
        h2 = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(lp, h2, cfg, positions, positions_3d)
        k_row.index_copy_(1, slot, k.to(cfg.dtype))
        v_row.index_copy_(1, slot, v.to(cfg.dtype))
        o = attention_decode(q, k_row, v_row, new_length, window=window)
        return x + o.reshape(b, 1, cfg.q_dim) @ lp["wo"]
