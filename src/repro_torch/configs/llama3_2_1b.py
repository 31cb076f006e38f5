"""llama3.2-1b [dense] -- 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256, tied embeddings, bf16 (``repro/configs/llama3_2_1b.py``)."""

from ..models.common import ModelConfig

ARCH = "llama3.2-1b"


def full() -> ModelConfig:
    return ModelConfig(
        arch=ARCH,
        family="dense",
        n_layers=16,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        d_ff=8192,
        vocab=128256,
        rope_theta=500000.0,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch=ARCH + "-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        rope_theta=10000.0,
        tie_embeddings=True,
    )
