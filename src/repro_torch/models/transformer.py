"""Model assembly for the dense family (llama-style: GQA, RoPE, SwiGLU,
RMSNorm, no biases) -- the port of ``repro/models/transformer.py``.

Parameters are a plain dict with the reference's names and its stacked
``[L, ...]`` layer layout, so a reference pytree carries over one to one
(:func:`repro_torch.convert.model_params_from_reference`).  The layers run
in a Python loop (no ``lax.scan``); attention and the FFN go through the
Hopper kernels.  Other families raise ``NotImplementedError`` (ROADMAP
Queue 1 item 11b).
"""

from __future__ import annotations

import math

import torch

from ..device import resolve_device
from .attention import attention_train
from .common import ModelConfig, apply_rope, rms_norm
from .ffn import swiglu

__all__ = ["init_params", "param_shapes", "forward", "layer_params", "require_dense"]


def require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.arch}) is not ported yet; the port runs the dense "
            "family (ROADMAP Queue 1 item 11b)")


def _normal(shape, scale=None):
    """``ParamStore.param``'s default init: normal times 1 / sqrt(fan_in)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return (shape, "normal", scale if scale is not None else 1.0 / math.sqrt(fan_in))


def _ones(shape):
    return (shape, "ones", None)


def _init_attn(cfg: ModelConfig, L: int) -> dict:
    d = cfg.d_model
    return {
        "attn_norm": _ones((L, d)),
        "wq": _normal((L, d, cfg.q_dim)),
        "wk": _normal((L, d, cfg.kv_dim)),
        "wv": _normal((L, d, cfg.kv_dim)),
        "wo": _normal((L, cfg.q_dim, d)),
    }


def _init_decoder_stack(cfg: ModelConfig, L: int) -> dict:
    """Attention plus the dense SwiGLU FFN, stacked over ``L`` layers."""
    d = cfg.d_model
    return {
        **_init_attn(cfg, L),
        "ffn_norm": _ones((L, d)),
        "wi_gate": _normal((L, d, cfg.d_ff)),
        "wi_up": _normal((L, d, cfg.d_ff)),
        "wo_ffn": _normal((L, cfg.d_ff, d)),
    }


def param_shapes(cfg: ModelConfig) -> dict:
    """Every parameter's ``(shape, init, scale)`` in the reference's
    ``ParamStore`` order, from the config alone (nothing is allocated)."""
    require_dense(cfg)
    d, v = cfg.d_model, cfg.vocab
    out = {"embed": _normal((v, d), 0.02)}
    if not cfg.tie_embeddings:
        out["lm_head"] = _normal((d, v))
    out["final_norm"] = _ones((d,))
    out["layers"] = _init_decoder_stack(cfg, cfg.n_layers)
    return out


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None) -> dict:
    """Random parameters with the reference's distributions (normal times
    1 / sqrt(fan_in), the embedding times 0.02, norms at one), drawn on
    ``device`` (default: the CUDA device) from a generator seeded with
    ``seed``, so a full-width model never passes through the host.  The
    numbers differ from the reference's ``jax.random`` draws."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def make(spec):
        shape, init, scale = spec
        if init == "ones":
            return torch.ones(shape, dtype=cfg.dtype, device=dev)
        x = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return x.mul_(scale).to(cfg.dtype)

    shapes = param_shapes(cfg)
    params = {k: make(s) for k, s in shapes.items() if k != "layers"}
    params["layers"] = {k: make(s) for k, s in shapes["layers"].items()}
    return params


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked ``[L, ...]`` parameters."""
    return {k: w[i] for k, w in params["layers"].items()}


def _attn_block(lp: dict, x, cfg: ModelConfig, positions, *, window: int | None):
    """Pre-norm attention with a residual; returns (x, (k, v)) with k after
    RoPE, as the cache stores it."""
    b, s, _ = x.shape
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = (h @ lp["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim_)
    k = (h @ lp["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim_)
    v = (h @ lp["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim_)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attention_train(q, k, v, causal=True, window=window)
    return x + o.reshape(b, s, cfg.q_dim) @ lp["wo"], (k, v)


def _ffn_block(lp: dict, x, cfg: ModelConfig):
    h = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
    o = swiglu({"wi_gate": lp["wi_gate"], "wi_up": lp["wi_up"], "wo": lp["wo_ffn"]}, h)
    return x + o


def attention_window(cfg: ModelConfig) -> int | None:
    return cfg.swa_window if cfg.attention == "swa" else None


def lm_head(params: dict, cfg: ModelConfig, x):
    """Final norm and the (tied) output projection, as ``repro.models.serve``
    applies them (no logit soft-cap there)."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head


def forward(params: dict, cfg: ModelConfig, batch: dict):
    """Training / eval forward: (logits [B, S, V], aux_loss []).  ``batch``
    holds ``"tokens"`` [B, S] on the parameters' device."""
    require_dense(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = params["embed"][tokens].to(cfg.dtype)
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    window = attention_window(cfg)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        x, _kv = _attn_block(lp, x, cfg, positions, window=window)
        x = _ffn_block(lp, x, cfg)
    logits = lm_head(params, cfg, x)
    if cfg.logit_softcap > 0:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)
