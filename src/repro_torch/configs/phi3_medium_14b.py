"""phi3-medium-14b [dense] -- 40L d_model=5120 40H (GQA kv=10, head dim
128) d_ff=17920 vocab=100352, RoPE, SwiGLU, untied embeddings
(``repro/configs/phi3_medium_14b.py``; arXiv:2404.14219)."""

from ..models.common import ModelConfig

ARCH = "phi3-medium-14b"


def full() -> ModelConfig:
    return ModelConfig(
        arch=ARCH,
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv_heads=10,
        d_ff=17920,
        vocab=100352,
        rope_theta=10000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch=ARCH + "-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=224,
        vocab=256,
        rope_theta=10000.0,
    )
