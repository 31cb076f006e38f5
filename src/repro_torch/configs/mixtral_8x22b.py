"""mixtral-8x22b [moe] -- 56L d_model=6144 48H (GQA kv=8, head dim 128)
d_ff=16384 vocab=32768, 8 experts top-2, a 4,096-token sliding window
(``repro/configs/mixtral_8x22b.py``; arXiv:2401.04088)."""

from ..models.common import ModelConfig

ARCH = "mixtral-8x22b"


def full() -> ModelConfig:
    return ModelConfig(
        arch=ARCH,
        family="moe",
        n_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,
        vocab=32768,
        rope_theta=1000000.0,
        attention="swa",
        swa_window=4096,
        n_experts=8,
        top_k=2,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch=ARCH + "-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        rope_theta=10000.0,
        attention="swa",
        swa_window=8,
        n_experts=4,
        top_k=2,
        # the reference's no-drop regime for its teacher-forcing test
        capacity_factor=8.0,
    )
