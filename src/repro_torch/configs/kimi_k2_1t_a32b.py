"""kimi-k2-1t-a32b [moe] -- 61L d_model=7168 64H (GQA kv=8, head dim 112)
vocab=163840, 384 experts of d_ff 2048, top-8, plus one shared expert
(``repro/configs/kimi_k2_1t_a32b.py``).

The public source is the model card, hf:moonshotai/Kimi-K2-Base (the
reference cites an unverified paper table).  The card's attention is MLA;
the reference's config, which this one copies field for field, stands in
GQA attention with 8 KV heads of head dim 112 for it."""

from ..models.common import ModelConfig

ARCH = "kimi-k2-1t-a32b"


def full() -> ModelConfig:
    return ModelConfig(
        arch=ARCH,
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        d_ff=2048,
        vocab=163840,
        rope_theta=1000000.0,
        n_experts=384,
        top_k=8,
        moe_d_ff=2048,
        n_shared_experts=1,
        capacity_factor=1.25,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch=ARCH + "-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=32,
        vocab=256,
        rope_theta=10000.0,
        n_experts=8,
        top_k=2,
        moe_d_ff=32,
        n_shared_experts=1,
    )
