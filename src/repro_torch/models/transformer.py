"""Model assembly -- the port of ``repro/models/transformer.py`` for all six
families:

  dense   llama-style (GQA, RoPE, SwiGLU, RMSNorm, no biases);
  moe     mixtral-8x22b (8 experts, top-2, a sliding window) and kimi-k2
          (384 experts, top-8, one shared expert): the dense attention with
          a capacity-based top-k MoE FFN (``models/ffn.py``), whose
          load-balancing loss ``forward`` returns as ``aux``;
  vlm     qwen2-vl-2b's backbone: qkv biases, M-RoPE over (t, h, w)
          position streams, and the patch embeddings (a stub input) as a
          prefix of the sequence;
  ssm     rwkv6 (Finch time-mix with the WKV scan + channel-mix; no
          attention);
  hybrid  zamba2 (Mamba2 SSD layers, with one shared attention + SwiGLU
          block applied after every ``hybrid_attn_every`` of them);
  audio   whisper-medium, an encoder-decoder: the encoder adds sinusoids
          to the frame embeddings (a stub input for the mel / conv front
          end) and runs bidirectional attention; each decoder layer runs
          causal self attention with RoPE, cross attention over the
          encoder's output and a two-matrix MLP with tanh-approximated GELU
          (JAX's default), every norm an RMS norm, as the reference has it.

Parameters are a plain dict with the reference's names and its stacked
``[L, ...]`` layer layout (zamba2's shared block under ``shared_attn``,
stacked ``[1, ...]``; kimi's shared expert under ``layers.shared``;
whisper's encoder under ``enc`` and its decoder under ``dec``), so a
reference pytree carries over one to one
(:func:`repro_torch.convert.model_params_from_reference`).  The layers run
in a Python loop (no ``lax.scan``); attention, the FFN and the two scans
go through the Hopper kernels, and in training through their autograd
Functions (kernel forward, plain backward); the routed experts' products
are ``torch.bmm`` (a prefill's on the card: the grouped kernels of
``kernels/moe_experts``, ``models/ffn.py``) and whisper's projections and
MLP ``@``, as the reference leaves them to XLA.  Every family serves and
trains.

Training rematerialises the layer bodies the reference wraps in
``jax.checkpoint(body, prevent_cse=False)`` -- the decoder's attention + FFN
layer, rwkv6's time-mix + channel-mix, zamba2's norm + mamba2 mixer, and
whisper's encoder and decoder layers -- through a non-reentrant
``torch.utils.checkpoint.checkpoint`` (:func:`_run_layer`): the forward
keeps each layer's inputs only, and the backward reruns the body (its
kernels too) before it differentiates it.  Zamba2's shared attention block
runs outside any checkpoint, as in the reference.  Serving runs under
``torch.no_grad()`` and calls the bodies directly.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import obs
from ..device import resolve_device
from ..kernels.rwkv6_scan import ops as rwkv6_ops
from ..kernels.ssd_scan import ops as ssd_ops
from .attention import attention_train
from .common import ModelConfig, apply_mrope, apply_rope, cross_entropy_loss, rms_norm
from .ffn import ep_shard, moe_layer, moe_layer_ep, swiglu
from .ssm import rwkv6_step, ssd_step

__all__ = ["init_params", "param_shapes", "param_axes", "forward", "loss_fn", "layer_params",
           "require_ported", "ep_shard_params", "PORTED_FAMILIES", "DECODER_FAMILIES"]

#: The families the port runs.
PORTED_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")

#: The families whose layers are the attention + FFN decoder stack.
DECODER_FAMILIES = ("dense", "moe", "vlm")

_RWKV_W_MIN = 0.05  # decay floor (the reference's)
_SSD_LOGA_MIN = -6.0


def require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.arch}) is not one the port runs; it runs the "
            "dense, moe, vlm, ssm, hybrid and audio families")


def _normal(shape, axes, scale=None):
    """``ParamStore.param``'s default init: normal times 1 / sqrt(fan_in)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return (shape, "normal", scale if scale is not None else 1.0 / math.sqrt(fan_in), axes)


def _ones(shape, axes):
    return (shape, "ones", None, axes)


def _zeros(shape, axes):
    return (shape, "zeros", None, axes)


def _uniform(shape, axes, scale):
    """``ParamStore``'s ``"uniform"`` init: U(-scale, scale)."""
    return (shape, "uniform", scale, axes)


_LD = ("layers", "d_model")


def _init_attn(cfg: ModelConfig, L: int, bias: bool = False) -> dict:
    d = cfg.d_model
    out = {
        "attn_norm": _ones((L, d), _LD),
        "wq": _normal((L, d, cfg.q_dim), ("layers", "d_model", "heads")),
        "wk": _normal((L, d, cfg.kv_dim), ("layers", "d_model", "kv_heads")),
        "wv": _normal((L, d, cfg.kv_dim), ("layers", "d_model", "kv_heads")),
        "wo": _normal((L, cfg.q_dim, d), ("layers", "heads", "d_model")),
    }
    if bias:  # qwen2-vl's qkv biases
        out.update(bq=_zeros((L, cfg.q_dim), ("layers", "heads")),
                   bk=_zeros((L, cfg.kv_dim), ("layers", "kv_heads")),
                   bv=_zeros((L, cfg.kv_dim), ("layers", "kv_heads")))
    return out


def _mlp(d: int, f: int, L: int) -> dict:
    """A SwiGLU's three matrices stacked over ``L`` layers."""
    up = ("layers", "d_model", "d_ff")
    return {"wi_gate": _normal((L, d, f), up), "wi_up": _normal((L, d, f), up),
            "wo": _normal((L, f, d), ("layers", "d_ff", "d_model"))}


def _init_decoder_stack(cfg: ModelConfig, L: int) -> dict:
    """Attention (with qkv biases under M-RoPE) plus the FFN, stacked over
    ``L`` layers: the dense SwiGLU, or the router, the experts and kimi's
    shared expert."""
    d = cfg.d_model
    out = {**_init_attn(cfg, L, bias=cfg.m_rope), "ffn_norm": _ones((L, d), _LD)}
    if cfg.n_experts > 0:
        e, f = cfg.n_experts, cfg.expert_ff
        up = ("layers", "experts", "d_model", "d_ff")
        out.update(router=_normal((L, d, e), ("layers", "d_model", "experts")),
                   moe_wi_gate=_normal((L, e, d, f), up), moe_wi_up=_normal((L, e, d, f), up),
                   moe_wo=_normal((L, e, f, d), ("layers", "experts", "d_ff", "d_model")))
        if cfg.n_shared_experts > 0:
            out["shared"] = _mlp(d, f * cfg.n_shared_experts, L)
        return out
    mlp = _mlp(d, cfg.d_ff, L)
    out.update(wi_gate=mlp["wi_gate"], wi_up=mlp["wi_up"], wo_ffn=mlp["wo"])
    return out


def _init_rwkv_stack(cfg: ModelConfig, L: int) -> dict:
    """RWKV6 time-mix (token-shift mixes, r / k / v / g projections, the
    LoRA decay and the bonus) and channel-mix, stacked over ``L`` layers."""
    d, f = cfg.d_model, cfg.d_ff
    lora = max(32, d // 32)
    dh = ("layers", "d_model", "heads")
    out = {"tm_norm": _ones((L, d), _LD)}
    for nm in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g"):
        out[nm] = _uniform((L, d), _LD, 0.5)
    for nm in ("wr", "wk", "wv", "wg"):
        out[nm] = _normal((L, d, d), dh)
    out.update({
        "w_base": _zeros((L, d), _LD),
        "w_lora_a": _normal((L, d, lora), ("layers", "d_model", None)),
        "w_lora_b": _zeros((L, lora, d), ("layers", None, "d_model")),
        "bonus_u": _uniform((L, d), _LD, 0.3),
        "ln_x": _ones((L, d), _LD),
        "wo": _normal((L, d, d), ("layers", "heads", "d_model")),
        "cm_norm": _ones((L, d), _LD),
        "cm_mu_k": _uniform((L, d), _LD, 0.5),
        "cm_mu_r": _uniform((L, d), _LD, 0.5),
        "cm_wk": _normal((L, d, f), ("layers", "d_model", "d_ff")),
        "cm_wv": _normal((L, f, d), ("layers", "d_ff", "d_model")),
        "cm_wr": _normal((L, d, d), dh),
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
        "norm": _ones((L, d), _LD),
        "in_proj": _normal((L, d, 2 * d_inner), ("layers", "d_model", "heads")),
        "bc_proj": _normal((L, d, 2 * dst), ("layers", "d_model", None)),
        "dt_proj": _normal((L, d, n_h), ("layers", "d_model", None)),
        "dt_bias": _zeros((L, n_h), ("layers", None)),
        "a_log": _uniform((L, n_h), ("layers", None), 1.0),
        "d_skip": _ones((L, n_h), ("layers", None)),
        "out_proj": _normal((L, d_inner, d), ("layers", "heads", "d_model")),
    }
    return layers, _init_decoder_stack(cfg, 1)


#: Whisper's per-layer leaves (the reference's ``_whisper_views``).
WHISPER_ENC_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "ffn_norm", "wi", "wo_ffn")
WHISPER_DEC_KEYS = WHISPER_ENC_KEYS + ("xattn_norm", "xq", "xk", "xv", "xo")


def _init_whisper(cfg: ModelConfig) -> tuple[dict, dict]:
    """(the encoder, the decoder): a scale on the sinusoids, the attention,
    the GELU MLP and a final norm stacked over the encoder's layers; the
    self attention, the cross attention and the MLP over the decoder's.  No
    biases and no learned position table, as the reference has it."""
    d, f = cfg.d_model, cfg.d_ff
    le, ld = cfg.enc_layers or cfg.n_layers, cfg.n_layers
    up, down = ("layers", "d_model", "d_ff"), ("layers", "d_ff", "d_model")
    enc = {"pos_scale": _ones((1,), (None,)), **_init_attn(cfg, le),
           "ffn_norm": _ones((le, d), _LD), "wi": _normal((le, d, f), up),
           "wo_ffn": _normal((le, f, d), down), "final_norm": _ones((d,), ("d_model",))}
    dec = {**_init_attn(cfg, ld), "xattn_norm": _ones((ld, d), _LD),
           "xq": _normal((ld, d, cfg.q_dim), ("layers", "d_model", "heads")),
           "xk": _normal((ld, d, cfg.kv_dim), ("layers", "d_model", "kv_heads")),
           "xv": _normal((ld, d, cfg.kv_dim), ("layers", "d_model", "kv_heads")),
           "xo": _normal((ld, cfg.q_dim, d), ("layers", "heads", "d_model")),
           "ffn_norm": _ones((ld, d), _LD), "wi": _normal((ld, d, f), up),
           "wo_ffn": _normal((ld, f, d), down)}
    return enc, dec


def _param_specs(cfg: ModelConfig) -> dict:
    """Every parameter's ``(shape, init, scale, logical axes)`` in the
    reference's ``ParamStore`` order."""
    require_ported(cfg)
    d, v = cfg.d_model, cfg.vocab
    out = {"embed": _normal((v, d), ("vocab", "d_model"), 0.02)}
    if not cfg.tie_embeddings:
        out["lm_head"] = _normal((d, v), ("d_model", "vocab"))
    out["final_norm"] = _ones((d,), ("d_model",))
    if cfg.family in DECODER_FAMILIES:
        out["layers"] = _init_decoder_stack(cfg, cfg.n_layers)
    elif cfg.family == "ssm":
        out["layers"] = _init_rwkv_stack(cfg, cfg.n_layers)
    elif cfg.family == "hybrid":
        out["layers"], out["shared_attn"] = _init_zamba_stack(cfg, cfg.n_layers)
    else:
        out["enc"], out["dec"] = _init_whisper(cfg)
    return out


def _spec_map(fn, tree):
    return {k: _spec_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def param_shapes(cfg: ModelConfig) -> dict:
    """Every parameter's ``(shape, init, scale)`` in the reference's
    ``ParamStore`` order, from the config alone (nothing is allocated)."""
    return _spec_map(lambda spec: spec[:3], _param_specs(cfg))


def param_axes(cfg: ModelConfig) -> dict:
    """Every parameter's logical axes (the reference's ``init_params``'
    second tree): :func:`param_shapes`' tree with one axis name (or
    ``None``) per dim of each leaf, from the config alone."""
    return _spec_map(lambda spec: spec[3], _param_specs(cfg))


#: The most elements :func:`init_params` draws at once (1 GB of float32).
DRAW_CHUNK = 1 << 28


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None) -> dict:
    """Random parameters with the reference's distributions (normal times
    1 / sqrt(fan_in), the embedding times 0.02, uniform, zeros and ones
    where the reference has them), drawn on ``device`` (default: the CUDA
    device) from a generator seeded with ``seed``, so a full-width model
    never passes through the host.  A leaf of more than ``DRAW_CHUNK``
    elements is drawn ``DRAW_CHUNK`` elements at a time (whole rows of its
    last axis), so its float32 draw never needs more than 1 GB beside the
    leaf (an expert stack of kimi-k2 is 5.6 B elements).  The numbers
    differ from the reference's ``jax.random`` draws."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(shape, init, scale):
        if init == "uniform":
            x = torch.rand(shape, generator=gen, dtype=torch.float32, device=dev)
            return x.mul_(2 * scale).sub_(scale).to(cfg.dtype)
        x = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return x.mul_(scale).to(cfg.dtype)

    def make(spec):
        if isinstance(spec, dict):
            return {k: make(s) for k, s in spec.items()}
        shape, init, scale, _axes = spec
        if init in ("ones", "zeros"):
            return (torch.ones if init == "ones" else torch.zeros)(shape, dtype=cfg.dtype,
                                                                   device=dev)
        if math.prod(shape) <= DRAW_CHUNK:
            return draw(shape, init, scale)
        out = torch.empty(shape, dtype=cfg.dtype, device=dev)
        rows = out.view(-1, shape[-1])
        step = max(1, DRAW_CHUNK // shape[-1])
        for i in range(0, rows.shape[0], step):
            part = rows[i:i + step]
            part.copy_(draw(tuple(part.shape), init, scale))
        return out

    return make(_param_specs(cfg))


def layer_params(params: dict, i: int, key: str = "layers") -> dict:
    """Layer ``i``'s slice of the stacked ``[L, ...]`` parameters under
    ``key`` (nested dicts, such as kimi's ``shared`` expert, sliced alike)."""

    def cut(tree):
        return {k: cut(w) if isinstance(w, dict) else w[i] for k, w in tree.items()}

    return cut(params[key])


def _run_layer(body, *args, cache: dict | None = None):
    """``body(*args)``; when autograd records the call and it writes no
    cache (training), through ``checkpoint(body, *args,
    use_reentrant=False)``, the counterpart of the reference's
    ``jax.checkpoint(body, prevent_cse=False)``: autograd keeps the body's
    inputs, and the backward reruns the body (the same operations on the
    same inputs, so the same values) before it differentiates it."""
    if cache is None and torch.is_grad_enabled():
        return checkpoint(body, *args, use_reentrant=False)
    return body(*args)


def _qkv(lp: dict, h, cfg: ModelConfig, positions, positions_3d):
    """The projections of the normed ``h`` [B, S, D] (plus the qkv biases
    where the layer has them) as [B, S, H, Dh] heads, q and k rotated: by
    M-RoPE over ``positions_3d`` [3, B, S] when the config has it and they
    are given, else by RoPE over ``positions`` [B, S]."""
    b, s, _ = h.shape
    q, k, v = h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]
    if "bq" in lp:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim_)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim_)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim_)
    if cfg.m_rope and positions_3d is not None:
        q = apply_mrope(q, positions_3d, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions_3d, cfg.rope_theta, cfg.mrope_sections)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _moe_params(lp: dict) -> dict:
    """A layer's (or the stacked layers') MoE leaves under the names of
    ``models/ffn.py``."""
    moe = {"router": lp["router"], "wi_gate": lp["moe_wi_gate"], "wi_up": lp["moe_wi_up"],
           "wo": lp["moe_wo"]}
    if "shared" in lp:
        moe["shared"] = lp["shared"]
    return moe


def ep_shard_params(params: dict, cfg: ModelConfig, ep_index: int, n_ep: int,
                    tp_index: int = 0, n_tp: int = 1) -> dict:
    """``params`` with every MoE layer's experts (and, over ``n_tp``, their
    and the shared expert's ``d_ff``) cut to a rank's
    :func:`~repro_torch.models.ffn.ep_shard`: what an expert-parallel rank
    holds for :func:`forward` with ``ep=``."""
    lay = params["layers"]
    cut = ep_shard(_moe_params(lay), cfg, ep_index, n_ep, tp_index, n_tp)
    new = {**lay, "moe_wi_gate": cut["wi_gate"], "moe_wi_up": cut["wi_up"],
           "moe_wo": cut["wo"]}
    if "shared" in cut:
        new["shared"] = cut["shared"]
    return {**params, "layers": new}


def _attn_block(lp: dict, x, cfg: ModelConfig, positions, *, window: int | None,
                positions_3d=None):
    """Pre-norm attention with a residual; returns (x, (k, v)) with k after
    RoPE, as the cache stores it."""
    b, s, _ = x.shape
    with obs.span("layer.attn"):
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(lp, h, cfg, positions, positions_3d)
        o = attention_train(q, k, v, causal=True, window=window)
        return x + o.reshape(b, s, cfg.q_dim) @ lp["wo"], (k, v)


def _ffn_block(lp: dict, x, cfg: ModelConfig, ep=None, routing=None):
    """Pre-norm FFN with a residual -> (x, aux): the dense SwiGLU (aux 0),
    or the MoE layer and its load-balancing loss -- expert-parallel over
    ``ep`` (:class:`~repro_torch.models.ffn.EPGroups`) when the config asks
    for it (``moe_impl == "shard_map_ep"``) and groups are given, the layer's
    MoE parameters then being the rank's :func:`~repro_torch.models.ffn
    .ep_shard`.  ``routing`` (a list) receives each MoE call's routing."""
    with obs.span("layer.ffn"):
        h = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
        if cfg.n_experts == 0:
            o = swiglu({"wi_gate": lp["wi_gate"], "wi_up": lp["wi_up"], "wo": lp["wo_ffn"]}, h)
            return x + o, torch.zeros((), dtype=torch.float32, device=x.device)
        moe = _moe_params(lp)
        if cfg.moe_impl == "shard_map_ep" and ep is not None:
            o, aux = moe_layer_ep(moe, h, cfg, ep)
        else:
            rec = {} if routing is not None else None
            o, aux = moe_layer(moe, h, cfg, rec)
            if routing is not None:
                routing.append(rec)
        return x + o, aux


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


def _rwkv_layer(lp: dict, x, tm_prev, cm_prev, st0, cfg: ModelConfig):
    """One RWKV layer's body (the reference's rematerialised scan body):
    the normed time-mix and channel-mix, each with its residual -> (x, the
    new time-mix shift, the new channel-mix shift, the new state)."""
    a = rms_norm(x, lp["tm_norm"], cfg.norm_eps)
    o, tm_new, st1 = _rwkv_time_mix(lp, a, tm_prev, cfg, st0)
    x = x + o
    c = rms_norm(x, lp["cm_norm"], cfg.norm_eps)
    o2, cm_new = _rwkv_channel_mix(lp, c, cm_prev)
    return x + o2, tm_new, cm_new, st1


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
        x, tm_new, cm_new, st1 = _run_layer(_rwkv_layer, lp, x, tm_prev, cm_prev, st0, cfg,
                                            cache=cache)
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
    return _ffn_block(sp, x, cfg)[0], kv


def _mamba_layer(lp: dict, x, cfg: ModelConfig):
    """One zamba2 mamba layer's body (the reference's rematerialised scan
    body): norm, mamba2 mixer from a zero state, residual -> (x, the final
    state)."""
    o, st = _mamba2_mixer(lp, rms_norm(x, lp["norm"], cfg.norm_eps), cfg)
    return x + o, st


def _zamba_layers(params: dict, x, cfg: ModelConfig, positions, cache: dict | None = None):
    """The zamba2 stack: each group of mamba layers, then the shared block
    (outside any checkpoint, as in the reference).
    With a cache (``ssm`` [L, B, H, Dst, 64] float32, ``k`` / ``v`` [G, B,
    S_max, Hkv, Dh]) the final states and each site's keys and values are
    written into it in place (the layers start from zero states, as the
    reference's prefill does)."""
    s = x.shape[1]
    for g, (lo, hi) in enumerate(shared_sites(cfg)):
        for i in range(lo, hi):
            x, st = _run_layer(_mamba_layer, layer_params(params, i), x, cfg, cache=cache)
            if cache is not None:
                cache["ssm"][i] = st
        x, (k, v) = _shared_attn_apply(params, x, cfg, positions)
        if cache is not None:
            cache["k"][g, :, :s] = k.to(cfg.dtype)
            cache["v"][g, :, :s] = v.to(cfg.dtype)
    return x


# -------------------------------------------------------------- whisper -- #
def whisper_layer(params: dict, i: int, side: str) -> dict:
    """Layer ``i`` of whisper's ``side`` (``"enc"`` or ``"dec"``): its
    per-layer leaves, without the encoder's ``pos_scale`` and
    ``final_norm``."""
    keys = WHISPER_ENC_KEYS if side == "enc" else WHISPER_DEC_KEYS
    return {k: params[side][k][i] for k in keys}


def _sinusoidal(s: int, d: int, device=None) -> torch.Tensor:
    """[S, D] float32: ``sin`` of position / 10000^(2i / D) in the first
    half, ``cos`` in the second (concatenated, not interleaved)."""
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / (10000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def _heads(t, n: int, cfg: ModelConfig):
    """[B, S, n * Dh] -> [B, S, n, Dh]."""
    return t.reshape(t.shape[0], t.shape[1], n, cfg.head_dim_)


def _gelu_mlp(lp: dict, x, cfg: ModelConfig):
    """Pre-norm two-matrix MLP with a residual; GELU in float32 with the
    tanh approximation (``jax.nn.gelu``'s default)."""
    f = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
    f = F.gelu((f @ lp["wi"]).to(torch.float32), approximate="tanh").to(x.dtype)
    return x + f @ lp["wo_ffn"]


def whisper_encoder(params: dict, frames, cfg: ModelConfig):
    """frames [B, S_enc, D] (the stub front end's embeddings, in
    ``cfg.dtype``) -> the encoder's output [B, S_enc, D]: the sinusoids
    times ``pos_scale`` (float32, cast to the frames' dtype after the
    product), bidirectional attention and the GELU MLP per layer, the final
    norm."""
    s, d = frames.shape[1:]
    enc = params["enc"]
    x = frames + (_sinusoidal(s, d, frames.device) * enc["pos_scale"]).to(frames.dtype)
    for i in range(cfg.enc_layers or cfg.n_layers):
        x = _run_layer(_whisper_enc_layer, whisper_layer(params, i, "enc"), x, cfg)
    return rms_norm(x, enc["final_norm"], cfg.norm_eps)


def _whisper_enc_layer(lp: dict, x, cfg: ModelConfig):
    """One encoder layer's body (rematerialised in training): bidirectional
    attention and the GELU MLP, each pre-norm with a residual."""
    b, s, _ = x.shape
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = _heads(h @ lp["wq"], cfg.n_heads, cfg)
    k, v = (_heads(h @ lp[w], cfg.n_kv_heads, cfg) for w in ("wk", "wv"))
    o = attention_train(q, k, v, causal=False)
    x = x + o.reshape(b, s, cfg.q_dim) @ lp["wo"]
    return _gelu_mlp(lp, x, cfg)


def _whisper_dec_layer(lp: dict, x, enc_out, positions, cfg: ModelConfig):
    """One decoder layer's body (rematerialised in training), the cross
    keys and values projected from ``enc_out`` inside it as in the
    reference -> (x, self k, self v, cross k, cross v)."""
    b, s, _ = x.shape
    x, (k, v) = _attn_block(lp, x, cfg, positions, window=None)
    h = rms_norm(x, lp["xattn_norm"], cfg.norm_eps)
    q = _heads(h @ lp["xq"], cfg.n_heads, cfg)
    xk, xv = (_heads(enc_out @ lp[w], cfg.n_kv_heads, cfg) for w in ("xk", "xv"))
    o = attention_train(q, xk, xv, causal=False)
    x = x + o.reshape(b, s, cfg.q_dim) @ lp["xo"]
    return _gelu_mlp(lp, x, cfg), k, v, xk, xv


def whisper_decoder(params: dict, x, enc_out, cfg: ModelConfig, positions,
                    cache: dict | None = None):
    """The decoder stack over ``x`` [B, S, D]: causal self attention with
    RoPE, cross attention of its queries over ``enc_out`` [B, S_enc, D]'s
    keys and values (bidirectional), the GELU MLP.  With a cache (``k`` /
    ``v`` [L, B, S_max, Hkv, Dh], ``xk`` / ``xv`` [L, B, S_enc, Hkv, Dh])
    each layer's self keys and values go to its first S positions and its
    cross keys and values fill ``xk`` / ``xv``, in place."""
    s = x.shape[1]
    for i in range(cfg.n_layers):
        x, k, v, xk, xv = _run_layer(_whisper_dec_layer, whisper_layer(params, i, "dec"), x,
                                     enc_out, positions, cfg, cache=cache)
        if cache is not None:
            cache["k"][i, :, :s] = k.to(cfg.dtype)
            cache["v"][i, :, :s] = v.to(cfg.dtype)
            cache["xk"][i] = xk.to(cfg.dtype)
            cache["xv"][i] = xv.to(cfg.dtype)
    return x


def embed_inputs(params: dict, cfg: ModelConfig, batch: dict, tokens):
    """The decoder's input sequence [B, P + S, D]: the vlm family's
    ``batch["patch_embeds"]`` [B, P, D] (when given) ahead of the tokens'
    embeddings; and its positions [B, P + S] (0, 1, ...)."""
    x = params["embed"][tokens].to(cfg.dtype)
    if cfg.family == "vlm" and "patch_embeds" in batch:
        patches = torch.as_tensor(batch["patch_embeds"], device=x.device).to(cfg.dtype)
        x = torch.cat([patches, x], dim=1)
    b, s = x.shape[:2]
    return x, torch.arange(s, device=x.device)[None].expand(b, s)


def _decoder_layer(lp: dict, x, positions, positions_3d, cfg: ModelConfig, window, ep, rec):
    """One attention + FFN layer's body (rematerialised in training) -> (x,
    aux, k, v).  ``rec`` (a dict, or None) receives the MoE layer's routing
    on the body's first run; a recompute routes into a throwaway list, so
    the forward's record stands and no layer is recorded twice."""
    x, (k, v) = _attn_block(lp, x, cfg, positions, window=window, positions_3d=positions_3d)
    sink = None if rec is None else []
    x, aux = _ffn_block(lp, x, cfg, ep, sink)
    if sink and not rec:
        rec.update(sink[0])
    return x, aux, k, v


def decoder_layers(params: dict, x, cfg: ModelConfig, positions, positions_3d=None, *,
                   ep=None, routing=None, cache: dict | None = None):
    """The attention + FFN stack of the dense, moe and vlm families -> (x,
    the layers' summed aux).  With a cache (``k`` / ``v`` [L, B, S_max,
    Hkv, Dh]) each layer's keys and values go to its first positions."""
    window = attention_window(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    s = x.shape[1]
    for i in range(cfg.n_layers):
        rec = {} if routing is not None else None
        x, a, k, v = _run_layer(_decoder_layer, layer_params(params, i), x, positions,
                                positions_3d, cfg, window, ep, rec, cache=cache)
        if rec:
            routing.append(rec)
        aux = aux + a
        if cache is not None:
            cache["k"][i, :, :s] = k.to(cfg.dtype)
            cache["v"][i, :, :s] = v.to(cfg.dtype)
    return x, aux


def forward(params: dict, cfg: ModelConfig, batch: dict, *, ep=None, routing=None):
    """Training / eval forward: (logits [B, S, V], aux_loss []).  ``batch``
    holds ``"tokens"`` [B, S] on the parameters' device; the vlm family
    also ``"patch_embeds"`` [B, P, D] and ``"positions_3d"`` [3, B, P + S]
    (the patches run ahead of the tokens and are stripped after the last
    layer); the audio family ``"frames"`` [B, S_enc, D], the encoder's
    input, the tokens being the decoder's.  ``aux_loss`` sums the MoE
    layers' load-balancing losses (0 for the other families).  ``ep``: the
    MoE layers' expert-parallel groups (the parameters' MoE leaves then the
    rank's shard); ``routing``: a list that receives each MoE layer's
    routing."""
    require_ported(cfg)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    zero = torch.zeros((), dtype=torch.float32, device=tokens.device)
    if cfg.family in DECODER_FAMILIES:
        x, positions = embed_inputs(params, cfg, batch, tokens)
        x, aux = decoder_layers(params, x, cfg, positions, batch.get("positions_3d"), ep=ep,
                                routing=routing)
        x = x[:, x.shape[1] - s:]
    elif cfg.family == "ssm":
        x, aux = _rwkv_layers(params, params["embed"][tokens].to(cfg.dtype), cfg), zero
    elif cfg.family == "hybrid":
        x, positions = embed_inputs(params, cfg, batch, tokens)
        x, aux = _zamba_layers(params, x, cfg, positions), zero
    else:
        x, positions = embed_inputs(params, cfg, batch, tokens)
        frames = torch.as_tensor(batch["frames"], device=x.device).to(cfg.dtype)
        enc = whisper_encoder(params, frames, cfg)
        x, aux = whisper_decoder(params, x, enc, cfg, positions), zero
    logits = lm_head(params, cfg, x)
    if cfg.logit_softcap > 0:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits, aux


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, aux_weight: float = 0.01, *,
            ep=None):
    """(total, {"loss", "aux_loss", "total"}): the cross entropy of
    :func:`forward`'s logits against ``batch["labels"]`` (masked by
    ``batch["mask"]`` when present) plus ``aux_weight`` times the aux loss."""
    logits, aux = forward(params, cfg, batch, ep=ep)
    loss = cross_entropy_loss(logits, batch["labels"], batch.get("mask"))
    total = loss + aux_weight * aux
    return total, {"loss": loss, "aux_loss": aux, "total": total}
