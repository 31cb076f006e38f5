"""Model substrate: config, norms and rotary embeddings (the port of
``repro/models/common.py``).

The logical-axis rules (:func:`axis_rules`, :func:`current_rules`,
:func:`current_mesh`, :func:`logical_to_spec`) are the reference's: a
spec is a tuple of mesh-axis entries (``None``, an axis name or a tuple of
names), as its ``PartitionSpec`` holds them.  The dry-run
(``launch/dryrun.py``) reads them to size each device's shards.  The
reference's ``shard()`` (a sharding constraint on an array) has no
counterpart: the port's model runs unsharded on one card, so a constraint
would have nothing to act on.  ``ParamStore``'s distributions live in
:func:`repro_torch.models.transformer.init_params`, its logical axes in
:func:`repro_torch.models.transformer.param_axes`.
Norms (:func:`rms_norm`, and :func:`layer_norm`, which no ported model
calls: the reference's whisper normalises with ``rms_norm``), RoPE and
Qwen2-VL's multimodal RoPE (:func:`apply_mrope`) compute in float32 inside
and cast back to the input's dtype, as the reference does.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import math
from dataclasses import dataclass
from typing import Any

import torch

__all__ = ["ModelConfig", "axis_rules", "current_rules", "current_mesh", "logical_to_spec",
           "rms_norm", "layer_norm", "rope_frequencies", "apply_rope",
           "apply_mrope", "mrope_positions", "cross_entropy_loss"]


@dataclass(frozen=True)
class ModelConfig:
    """One config for every architecture family (see ``configs/``); the
    fields of the reference's ``ModelConfig``, with ``dtype`` a torch dtype."""

    arch: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # attention
    attention: str = "full"  # full | swa | none
    swa_window: int = 4096
    rope_theta: float = 500000.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    hybrid_attn_every: int = 0
    # enc-dec (whisper)
    enc_dec: bool = False
    enc_layers: int = 0
    enc_seq: int = 1500
    # VLM (qwen2-vl)
    m_rope: bool = False
    mrope_sections: tuple[int, int, int] = (16, 24, 24)
    # implementation knobs of the reference (no meaning once a kernel runs
    # the attention; kept so configs carry over field for field)
    attn_impl: str = "naive"
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 1024
    moe_impl: str = "gspmd"
    # numerics
    dtype: Any = torch.bfloat16
    norm_eps: float = 1e-5
    logit_softcap: float = 0.0
    tie_embeddings: bool = False

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim_

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim_

    @property
    def expert_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def params_count(self) -> int:
        """Total parameter count (the reference's formula, every family)."""
        d = self.d_model
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.family in ("ssm",):
            per_layer = 4 * d * d + 2 * d * self.d_ff + d * d
        elif self.family == "hybrid":
            d_inner = 2 * d
            n_h = d_inner // 64
            per_layer = d * 2 * d_inner + d * 2 * self.ssm_state + d * n_h + d_inner * d
        else:
            per_layer = attn + 3 * d * self.d_ff
        if self.n_experts > 0:
            moe = self.n_experts * 3 * d * self.expert_ff
            dense_ffn = 3 * d * self.expert_ff * self.n_shared_experts
            per_layer = attn + moe + dense_ffn + d * self.n_experts
        if self.family == "audio":
            per_layer = 2 * attn + 2 * d * self.d_ff
        n = self.n_layers * per_layer + self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.family == "hybrid":
            n += attn + 3 * d * self.d_ff
        if self.enc_dec:
            n += self.enc_layers * (attn + 2 * d * self.d_ff + attn)
        return n

    def active_params_count(self) -> int:
        """Active parameters per token (the reference's formula): the MoE
        families count only the ``top_k`` routed and the shared experts."""
        if self.n_experts == 0:
            return self.params_count()
        d = self.d_model
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        active_moe = (self.top_k + self.n_shared_experts) * 3 * d * self.expert_ff
        per_layer = attn + active_moe + d * self.n_experts
        return self.n_layers * per_layer + self.vocab * d * 2


# --------------------------------------------------------------------------- #
# Logical axis rules (context)
# --------------------------------------------------------------------------- #
_RULES: contextvars.ContextVar = contextvars.ContextVar("axis_rules", default=None)
_MESH: contextvars.ContextVar = contextvars.ContextVar("model_mesh", default=None)


@contextlib.contextmanager
def axis_rules(rules: dict[str, Any], mesh: Any = None):
    """Activate logical -> mesh axis rules, e.g. ``{"batch": ("pod",
    "data"), "heads": "model"}`` (values a name, a tuple of names or
    ``None``), and the mesh they map onto."""
    tok = _RULES.set(tuple(rules.items()))
    tok_m = _MESH.set(mesh)
    try:
        yield
    finally:
        _RULES.reset(tok)
        _MESH.reset(tok_m)


def current_rules() -> dict[str, Any]:
    r = _RULES.get()
    return dict(r) if r else {}


def current_mesh():
    return _MESH.get()


def logical_to_spec(axes: tuple, rules: dict[str, Any] | None = None) -> tuple:
    """The spec of logical ``axes`` under ``rules`` (default: the active
    ones): each entry the mesh axes its rule names, ``None`` for no rule.
    A mesh axis serves one tensor dim only: a later dim whose axes are all
    taken gets ``None``, one with some free keeps those."""
    rules = current_rules() if rules is None else rules
    used: set[str] = set()
    spec = []
    for ax in axes:
        m = rules.get(ax) if ax is not None else None
        if m is None:
            spec.append(None)
            continue
        free = tuple(p for p in ((m,) if isinstance(m, str) else tuple(m)) if p not in used)
        if not free:
            spec.append(None)
            continue
        used.update(free)
        spec.append(free[0] if len(free) == 1 else free)
    return tuple(spec)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.to(torch.float32)).to(dt)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the last axis in float32 (the biased variance), times
    ``weight`` plus ``bias`` when given, cast back to ``x``'s dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    x = (x - mu) * torch.rsqrt(var + eps) * weight.to(torch.float32)
    if bias is not None:
        x = x + bias.to(torch.float32)
    return x.to(dt)


@functools.lru_cache(maxsize=None)
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for rotary embeddings [head_dim // 2], float32,
    computed on the CPU and copied to ``device`` once (one tensor shared by
    every caller: read it, do not write it), so every device rotates by the
    same angles: computed on the card, 30 of head dim 112's 56 entries come
    out one ulp off the CPU's, which at position 524,287 moves an angle by
    up to ~0.03 rad (``tools/rope_probe.py``; the CPU's table is the JAX
    package's but for one entry at head dims 112 and 128)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    return (1.0 / (theta ** exps)).to(device or "cpu")


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, Dh]; positions: [B, S] integer -> rotated x."""
    dh = x.shape[-1]
    inv = rope_frequencies(dh, theta, device=x.device)
    angles = positions[..., None].to(torch.float32) * inv  # [B, S, Dh/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor, theta: float,
                sections: tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE (arXiv:2409.12191 §3.1): x [B, S, H, Dh],
    positions_3d [3, B, S] the (t, h, w) position ids.  The half head dim is
    cut into ``sections`` frequency bands, in that order; each band rotates
    by its own position stream."""
    dh = x.shape[-1]
    if sum(sections) != dh // 2:
        raise ValueError(f"apply_mrope: sections {tuple(sections)} do not sum to {dh // 2}")
    inv = rope_frequencies(dh, theta, device=x.device)
    sec_id = torch.repeat_interleave(torch.arange(3, device=x.device),
                                     torch.tensor(sections, device=x.device),
                                     output_size=dh // 2)  # [Dh/2]
    pos = positions_3d.to(torch.float32)[sec_id]  # [Dh/2, B, S]
    angles = pos.permute(1, 2, 0) * inv  # [B, S, Dh/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mrope_positions(b: int, n_patches: int, s_text: int, *, device=None) -> torch.Tensor:
    """Qwen2-VL's (t, h, w) position ids [3, B, P + S] (int64) of one image
    of ``n_patches`` patches on a square grid (t 0, h the row, w the
    column) ahead of ``s_text`` text tokens, whose three ids continue from
    the largest patch id plus one."""
    side = math.isqrt(n_patches)
    if side * side != n_patches:
        raise ValueError(f"mrope_positions: {n_patches} patches are not a square grid")
    i = torch.arange(n_patches, device=device)
    patch = torch.stack([torch.zeros_like(i), i // side, i % side])
    text = torch.arange(s_text, device=device).expand(3, s_text) + (side if n_patches else 0)
    return torch.cat([patch, text], dim=1)[:, None].expand(3, b, n_patches + s_text)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token cross entropy in float32; logits [B, S, V], labels
    [B, S] (the reference's ``logsumexp - gold``, masked mean with
    ``mask``)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None].to(torch.int64), dim=-1)[..., 0]
    nll = logz - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()
