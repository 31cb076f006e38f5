"""whisper-medium [audio] -- encoder-decoder, 24 + 24 layers, d_model 1024,
16 heads (MHA, head dim 64), d_ff 4096, vocab 51865, 1,500 encoder frames
(30 s of audio at 50 frames / s); the mel / conv front end is a stub input
of frame embeddings (``repro/configs/whisper_medium.py``; arXiv:2212.04356).
Like the reference, the decoder rotates its self attention with RoPE and
every norm is an RMS norm."""

from ..models.common import ModelConfig

ARCH = "whisper-medium"


def full() -> ModelConfig:
    return ModelConfig(
        arch=ARCH,
        family="audio",
        n_layers=24,  # decoder layers
        enc_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=4096,
        vocab=51865,
        enc_dec=True,
        enc_seq=1500,
        rope_theta=10000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch=ARCH + "-smoke",
        family="audio",
        n_layers=2,
        enc_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=256,
        enc_dec=True,
        enc_seq=32,
        rope_theta=10000.0,
    )
