"""qwen2-vl-2b [vlm] -- 28L d_model=1536 12H (GQA kv=2, head dim 128)
d_ff=8960 vocab=151936, tied embeddings, M-RoPE over (t, h, w) bands of
16 / 24 / 24 frequencies; the vision tower is a stub input of patch
embeddings (``repro/configs/qwen2_vl_2b.py``; arXiv:2409.12191)."""

from ..models.common import ModelConfig

ARCH = "qwen2-vl-2b"

#: Patches ahead of the text in ``configs/shapes.py:input_specs`` (the
#: reference's fixed stub count; dynamic resolution is the frontend's).
N_PATCHES = 256


def full() -> ModelConfig:
    return ModelConfig(
        arch=ARCH,
        family="vlm",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        d_ff=8960,
        vocab=151936,
        rope_theta=1000000.0,
        m_rope=True,
        mrope_sections=(16, 24, 24),
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch=ARCH + "-smoke",
        family="vlm",
        n_layers=2,
        d_model=48,
        n_heads=3,
        n_kv_heads=1,
        d_ff=96,
        vocab=256,
        rope_theta=10000.0,
        m_rope=True,
        mrope_sections=(4, 2, 2),  # head dim 16 -> 8 frequencies
        tie_embeddings=True,
    )
