"""command-r-35b [dense] -- 40L d_model=8192 64H (GQA kv=8, head dim 128)
d_ff=22528 vocab=256000, no biases, tied embeddings
(``repro/configs/command_r_35b.py``; hf:CohereForAI/c4ai-command-r-v01)."""

from ..models.common import ModelConfig

ARCH = "command-r-35b"


def full() -> ModelConfig:
    return ModelConfig(
        arch=ARCH,
        family="dense",
        n_layers=40,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22528,
        vocab=256000,
        rope_theta=8000000.0,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch=ARCH + "-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=1,
        d_ff=176,
        vocab=512,
        rope_theta=10000.0,
        tie_embeddings=True,
    )
