"""rwkv6-1.6b [ssm] -- Finch: 24L d_model=2048 (attention-free, 32 WKV heads
of 64) d_ff=7168 vocab=65536, data-dependent decay
(``repro/configs/rwkv6_1_6b.py``; arXiv:2404.05892)."""

from ..models.common import ModelConfig

ARCH = "rwkv6-1.6b"


def full() -> ModelConfig:
    return ModelConfig(
        arch=ARCH,
        family="ssm",
        n_layers=24,
        d_model=2048,
        n_heads=32,  # wkv heads (head size 64)
        n_kv_heads=32,
        d_ff=7168,
        vocab=65536,
        attention="none",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch=ARCH + "-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=256,
        attention="none",
    )
