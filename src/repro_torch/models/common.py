"""Model substrate: config, norms and rotary embeddings (the port of
``repro/models/common.py``).

There is no sharding on one device, so the logical-axis rules and
``shard()`` are not ported; ``ParamStore``'s distributions live in
:func:`repro_torch.models.transformer.init_params`.  Norms and RoPE compute
in float32 inside and cast back to the input's dtype, as the reference
does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

__all__ = ["ModelConfig", "rms_norm", "rope_frequencies", "apply_rope", "cross_entropy_loss"]


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


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.to(torch.float32)).to(dt)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for rotary embeddings [head_dim // 2], float32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


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
