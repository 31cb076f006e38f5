"""yi-34b [dense] -- 60L d_model=7168 56H (GQA kv=8, head dim 128)
d_ff=20480 vocab=64000, llama architecture, untied embeddings
(``repro/configs/yi_34b.py``; arXiv:2403.04652)."""

from ..models.common import ModelConfig

ARCH = "yi-34b"


def full() -> ModelConfig:
    return ModelConfig(
        arch=ARCH,
        family="dense",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=20480,
        vocab=64000,
        rope_theta=5000000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch=ARCH + "-smoke",
        family="dense",
        n_layers=3,
        d_model=56,  # 7 heads of 8 over one KV head: the full model's ratio of 7
        n_heads=7,
        n_kv_heads=1,
        d_ff=160,
        vocab=256,
        rope_theta=10000.0,
    )
