"""Model assembly -- the port of ``repro/models/transformer.py`` for three
families:

  dense   llama-style (GQA, RoPE, SwiGLU, RMSNorm, no biases);
  ssm     rwkv6 (Finch time-mix with the WKV scan + channel-mix; no
          attention);
  hybrid  zamba2 (Mamba2 SSD layers, with one shared attention + SwiGLU
          block applied after every ``hybrid_attn_every`` of them).

Parameters are a plain dict with the reference's names and its stacked
``[L, ...]`` layer layout (zamba2's shared block under ``shared_attn``,
stacked ``[1, ...]``), so a reference pytree carries over one to one
(:func:`repro_torch.convert.model_params_from_reference`).  The layers run
in a Python loop (no ``lax.scan``); attention, the FFN and the two scans
go through the Hopper kernels.  The moe, vlm and audio families raise
``NotImplementedError`` (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..kernels.rwkv6_scan import ops as rwkv6_ops
from ..kernels.ssd_scan import ops as ssd_ops
from .attention import attention_train
from .common import ModelConfig, apply_rope, cross_entropy_loss, rms_norm
from .ffn import swiglu
from .ssm import rwkv6_step, ssd_step

__all__ = ["init_params", "param_shapes", "forward", "loss_fn", "layer_params",
           "require_ported", "PORTED_FAMILIES"]

#: The families the port runs.
PORTED_FAMILIES = ("dense", "ssm", "hybrid")

_RWKV_W_MIN = 0.05  # decay floor (the reference's)
_SSD_LOGA_MIN = -6.0


def require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.arch}) is not ported yet; the port runs the dense, "
            "ssm and hybrid families (ROADMAP Queue 1 item 5)")


def _normal(shape, scale=None):
    """``ParamStore.param``'s default init: normal times 1 / sqrt(fan_in)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return (shape, "normal", scale if scale is not None else 1.0 / math.sqrt(fan_in))


def _ones(shape):
    return (shape, "ones", None)


def _zeros(shape):
    return (shape, "zeros", None)


def _uniform(shape, scale):
    """``ParamStore``'s ``"uniform"`` init: U(-scale, scale)."""
    return (shape, "uniform", scale)


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


def _init_rwkv_stack(cfg: ModelConfig, L: int) -> dict:
    """RWKV6 time-mix (token-shift mixes, r / k / v / g projections, the
    LoRA decay and the bonus) and channel-mix, stacked over ``L`` layers."""
    d, f = cfg.d_model, cfg.d_ff
    lora = max(32, d // 32)
    out = {"tm_norm": _ones((L, d))}
    for nm in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g"):
        out[nm] = _uniform((L, d), 0.5)
    for nm in ("wr", "wk", "wv", "wg"):
        out[nm] = _normal((L, d, d))
    out.update({
        "w_base": _zeros((L, d)),
        "w_lora_a": _normal((L, d, lora)),
        "w_lora_b": _zeros((L, lora, d)),
        "bonus_u": _uniform((L, d), 0.3),
        "ln_x": _ones((L, d)),
        "wo": _normal((L, d, d)),
        "cm_norm": _ones((L, d)),
        "cm_mu_k": _uniform((L, d), 0.5),
        "cm_mu_r": _uniform((L, d), 0.5),
        "cm_wk": _normal((L, d, f)),
        "cm_wv": _normal((L, f, d)),
        "cm_wr": _normal((L, d, d)),
    })
    return out


def _init_zamba_stack(cfg: ModelConfig, L: int) -> tuple[dict, dict]:
    """(the Mamba2 layers stacked over ``L``, the shared attention + SwiGLU
    block stacked over 1).  The mamba layers carry no MLP of their own."""
    d = cfg.d_model
    d_inner = 2 * d
    n_h = d_inner // 64  # mamba2 head dim 64
    dst = cfg.ssm_state
    layers = {
        "norm": _ones((L, d)),
        "in_proj": _normal((L, d, 2 * d_inner)),
        "bc_proj": _normal((L, d, 2 * dst)),
        "dt_proj": _normal((L, d, n_h)),
        "dt_bias": _zeros((L, n_h)),
        "a_log": _uniform((L, n_h), 1.0),
        "d_skip": _ones((L, n_h)),
        "out_proj": _normal((L, d_inner, d)),
    }
    return layers, _init_decoder_stack(cfg, 1)


def param_shapes(cfg: ModelConfig) -> dict:
    """Every parameter's ``(shape, init, scale)`` in the reference's
    ``ParamStore`` order, from the config alone (nothing is allocated)."""
    require_ported(cfg)
    d, v = cfg.d_model, cfg.vocab
    out = {"embed": _normal((v, d), 0.02)}
    if not cfg.tie_embeddings:
        out["lm_head"] = _normal((d, v))
    out["final_norm"] = _ones((d,))
    if cfg.family == "dense":
        out["layers"] = _init_decoder_stack(cfg, cfg.n_layers)
    elif cfg.family == "ssm":
        out["layers"] = _init_rwkv_stack(cfg, cfg.n_layers)
    else:
        out["layers"], out["shared_attn"] = _init_zamba_stack(cfg, cfg.n_layers)
    return out


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None) -> dict:
    """Random parameters with the reference's distributions (normal times
    1 / sqrt(fan_in), the embedding times 0.02, uniform, zeros and ones
    where the reference has them), drawn on ``device`` (default: the CUDA
    device) from a generator seeded with ``seed``, so a full-width model
    never passes through the host.  The numbers differ from the
    reference's ``jax.random`` draws."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def make(spec):
        if isinstance(spec, dict):
            return {k: make(s) for k, s in spec.items()}
        shape, init, scale = spec
        if init in ("ones", "zeros"):
            return (torch.ones if init == "ones" else torch.zeros)(shape, dtype=cfg.dtype,
                                                                   device=dev)
        if init == "uniform":
            x = torch.rand(shape, generator=gen, dtype=torch.float32, device=dev)
            return x.mul_(2 * scale).sub_(scale).to(cfg.dtype)
        x = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return x.mul_(scale).to(cfg.dtype)

    return make(param_shapes(cfg))


def layer_params(params: dict, i: int, key: str = "layers") -> dict:
    """Layer ``i``'s slice of the stacked ``[L, ...]`` parameters under
    ``key``."""
    return {k: w[i] for k, w in params[key].items()}


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


# ---------------------------------------------------------------- RWKV6 -- #
def _token_shift(x, x_prev):
    """[x_prev, x_0, ..., x_{S-2}]: each token's predecessor."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _rwkv_time_mix(lp: dict, x, x_prev, cfg: ModelConfig, state=None):
    """x [B, S, D] (normed), x_prev [B, D] the previous segment's last token,
    state [B, H, Dk, Dv] float32 or None (zeros) -> (out [B, S, D], the new
    shift x[:, -1], the new state).  A single token with a state takes the
    step recurrence; otherwise the chunk scan runs in chunks of 32, the last
    one short when 32 does not divide S (the kernel for CUDA tensors)."""
    b, s, d = x.shape
    n_h = cfg.n_heads
    dh = d // n_h
    xs = _token_shift(x, x_prev)

    def mix(mu):
        return x + (xs - x) * mu

    r = mix(lp["mu_r"]) @ lp["wr"]
    k = mix(lp["mu_k"]) @ lp["wk"]
    v = mix(lp["mu_v"]) @ lp["wv"]
    g = F.silu((mix(lp["mu_g"]) @ lp["wg"]).to(torch.float32)).to(x.dtype)
    w_raw = lp["w_base"] + torch.tanh(mix(lp["mu_w"]) @ lp["w_lora_a"]) @ lp["w_lora_b"]
    w = torch.clamp(torch.exp(-F.softplus(-w_raw.to(torch.float32))), _RWKV_W_MIN, 0.9995)
    u = lp["bonus_u"].to(torch.float32).reshape(n_h, dh)

    def heads(t):
        return t.reshape(b, s, n_h, dh)

    if s == 1 and state is not None:
        o, new_state = rwkv6_step(heads(r)[:, 0], heads(k)[:, 0], heads(v)[:, 0],
                                  heads(w)[:, 0], u, state)
        o = o.reshape(b, s, d)
    else:
        # [B, H, S, Dh] views of the [B, S, D] projections; the kernel writes
        # its output as a [B, S, H, Dh] buffer, so the reshape is free.
        o, new_state = rwkv6_ops.rwkv6_scan(
            *(heads(t).transpose(1, 2) for t in (r, k, v, torch.log(w))), u, state, chunk=32)
        o = o.transpose(1, 2).reshape(b, s, d)
    o = rms_norm(o, lp["ln_x"], cfg.norm_eps) * g
    return o @ lp["wo"], x[:, -1], new_state


def _rwkv_channel_mix(lp: dict, x, x_prev):
    xs = _token_shift(x, x_prev)
    mk = x + (xs - x) * lp["cm_mu_k"]
    mr = x + (xs - x) * lp["cm_mu_r"]
    k = torch.square(torch.relu((mk @ lp["cm_wk"]).to(torch.float32))).to(x.dtype)
    gate = torch.sigmoid((mr @ lp["cm_wr"]).to(torch.float32)).to(x.dtype)
    return gate * (k @ lp["cm_wv"]), x[:, -1]


def _rwkv_layers(params: dict, x, cfg: ModelConfig, cache: dict | None = None):
    """The RWKV layer stack.  Without a cache every layer starts from zero
    shifts and a zero state; with one (``tm_shift`` / ``cm_shift`` [L, B,
    D], ``wkv`` [L, B, H, Dk, Dv] float32) each layer starts from its entry
    and writes its new shifts and state back in place."""
    zeros = torch.zeros((x.shape[0], x.shape[2]), dtype=x.dtype, device=x.device)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        tm_prev = cache["tm_shift"][i] if cache is not None else zeros
        cm_prev = cache["cm_shift"][i] if cache is not None else zeros
        st0 = cache["wkv"][i] if cache is not None else None
        a = rms_norm(x, lp["tm_norm"], cfg.norm_eps)
        o, tm_new, st1 = _rwkv_time_mix(lp, a, tm_prev, cfg, st0)
        x = x + o
        c = rms_norm(x, lp["cm_norm"], cfg.norm_eps)
        o2, cm_new = _rwkv_channel_mix(lp, c, cm_prev)
        x = x + o2
        if cache is not None:
            cache["tm_shift"][i] = tm_new
            cache["cm_shift"][i] = cm_new
            cache["wkv"][i] = st1
    return x


# ---------------------------------------------- zamba2 (mamba2 + shared) -- #
def _mamba2_mixer(lp: dict, x, cfg: ModelConfig, state=None):
    """x [B, S, D] (normed), state [B, H, Dst, 64] float32 or None (zeros)
    -> (y [B, S, D], the final state).  A single token with a state takes
    the step recurrence; otherwise the chunk scan runs in chunks of 64, the
    last one short when 64 does not divide S (the kernel for CUDA tensors),
    reading B and C -- shared by all heads -- as expanded views."""
    b, s, d = x.shape
    d_inner = 2 * d
    n_h = d_inner // 64
    dst = cfg.ssm_state
    z, xin = torch.chunk(x @ lp["in_proj"], 2, dim=-1)
    bmat, cmat = torch.chunk(x @ lp["bc_proj"], 2, dim=-1)
    dt = F.softplus((x @ lp["dt_proj"] + lp["dt_bias"]).to(torch.float32))  # [B, S, H]
    a_log = -torch.exp(lp["a_log"].to(torch.float32))
    loga = torch.clamp(dt * a_log, _SSD_LOGA_MIN, 0.0)
    xin_h = xin.reshape(b, s, n_h, 64)
    xh = xin_h * dt[..., None].to(x.dtype)
    if s == 1 and state is not None:
        y, new_state = ssd_step(xh[:, 0], loga[:, 0], bmat[:, 0, None].expand(b, n_h, dst),
                                cmat[:, 0, None].expand(b, n_h, dst), state)
        y = y[:, None]
    else:
        y, new_state = ssd_ops.ssd_scan(
            xh.transpose(1, 2), loga.transpose(1, 2), bmat[:, None].expand(b, n_h, s, dst),
            cmat[:, None].expand(b, n_h, s, dst), state, chunk=64)
        y = y.transpose(1, 2)
    y = y + xin_h * lp["d_skip"][None, None, :, None].to(x.dtype)
    y = y.reshape(b, s, d_inner) * F.silu(z.to(torch.float32)).to(x.dtype)
    return y @ lp["out_proj"], new_state


def shared_sites(cfg: ModelConfig) -> list[tuple[int, int]]:
    """``(first, end)`` layer spans of the zamba2 groups; the shared block
    runs after each (the reference's ``_n_shared_sites`` groups)."""
    every = max(cfg.hybrid_attn_every, 1)
    return [(i, min(i + every, cfg.n_layers)) for i in range(0, cfg.n_layers, every)]


def _shared_attn_apply(params: dict, x, cfg: ModelConfig, positions):
    """The shared attention + SwiGLU block (zamba2); returns (x, (k, v))."""
    sp = layer_params(params, 0, "shared_attn")
    x, kv = _attn_block(sp, x, cfg, positions, window=None)
    return _ffn_block(sp, x, cfg), kv


def _zamba_layers(params: dict, x, cfg: ModelConfig, positions, cache: dict | None = None):
    """The zamba2 stack: each group of mamba layers, then the shared block.
    With a cache (``ssm`` [L, B, H, Dst, 64] float32, ``k`` / ``v`` [G, B,
    S_max, Hkv, Dh]) the final states and each site's keys and values are
    written into it in place (the layers start from zero states, as the
    reference's prefill does)."""
    s = x.shape[1]
    for g, (lo, hi) in enumerate(shared_sites(cfg)):
        for i in range(lo, hi):
            lp = layer_params(params, i)
            o, st = _mamba2_mixer(lp, rms_norm(x, lp["norm"], cfg.norm_eps), cfg)
            x = x + o
            if cache is not None:
                cache["ssm"][i] = st
        x, (k, v) = _shared_attn_apply(params, x, cfg, positions)
        if cache is not None:
            cache["k"][g, :, :s] = k.to(cfg.dtype)
            cache["v"][g, :, :s] = v.to(cfg.dtype)
    return x


def forward(params: dict, cfg: ModelConfig, batch: dict):
    """Training / eval forward: (logits [B, S, V], aux_loss []).  ``batch``
    holds ``"tokens"`` [B, S] on the parameters' device."""
    require_ported(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = params["embed"][tokens].to(cfg.dtype)
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    if cfg.family == "dense":
        window = attention_window(cfg)
        for i in range(cfg.n_layers):
            lp = layer_params(params, i)
            x, _kv = _attn_block(lp, x, cfg, positions, window=window)
            x = _ffn_block(lp, x, cfg)
    elif cfg.family == "ssm":
        x = _rwkv_layers(params, x, cfg)
    else:
        x = _zamba_layers(params, x, cfg, positions)
    logits = lm_head(params, cfg, x)
    if cfg.logit_softcap > 0:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, aux_weight: float = 0.01):
    """(total, {"loss", "aux_loss", "total"}): the cross entropy of
    :func:`forward`'s logits against ``batch["labels"]`` (masked by
    ``batch["mask"]`` when present) plus ``aux_weight`` times the aux loss."""
    logits, aux = forward(params, cfg, batch)
    loss = cross_entropy_loss(logits, batch["labels"], batch.get("mask"))
    total = loss + aux_weight * aux
    return total, {"loss": loss, "aux_loss": aux, "total": total}
