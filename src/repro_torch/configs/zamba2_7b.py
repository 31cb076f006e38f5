"""zamba2-7b [hybrid] -- 81 Mamba2 layers, d_model=3584, and one shared
attention + MLP block (32 heads of 112, MHA, d_ff=14336) applied after
every 6 of them; vocab=32000, ssm_state=64 (``repro/configs/zamba2_7b.py``;
arXiv:2411.15242)."""

from ..models.common import ModelConfig

ARCH = "zamba2-7b"


def full() -> ModelConfig:
    return ModelConfig(
        arch=ARCH,
        family="hybrid",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,  # shared block is full MHA
        d_ff=14336,
        vocab=32000,
        rope_theta=10000.0,
        ssm_state=64,
        hybrid_attn_every=6,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch=ARCH + "-smoke",
        family="hybrid",
        n_layers=5,  # two groups: 3 + 2 with attn sites after each
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=256,
        rope_theta=10000.0,
        ssm_state=8,
        hybrid_attn_every=3,
    )
