"""Architecture configs of the port (``repro/configs``).

``get_config(arch, preset)`` returns a :class:`~repro_torch.models.common
.ModelConfig`: preset ``"full"`` is the published configuration, ``"smoke"``
a reduced one of the same family for CPU tests.  Ported: the dense
family's ``llama3.2-1b`` (head dim 64) and ``phi3-medium-14b``, ``yi-34b``
and ``command-r-35b`` (head dim 128), the moe family's ``mixtral-8x22b``
(head dim 128) and ``kimi-k2-1t-a32b`` (head dim 112), the vlm family's
``qwen2-vl-2b`` (head dim 128), the ssm family's ``rwkv6-1.6b``, the
hybrid family's ``zamba2-7b`` and the audio family's ``whisper-medium``
(an encoder-decoder, head dim 64): every architecture of the reference.
"""

from __future__ import annotations

import importlib

__all__ = ["ARCHS", "get_config", "for_kernels"]

ARCHS = [
    "rwkv6-1.6b",
    "command-r-35b",
    "llama3.2-1b",
    "yi-34b",
    "phi3-medium-14b",
    "qwen2-vl-2b",
    "mixtral-8x22b",
    "kimi-k2-1t-a32b",
    "zamba2-7b",
    "whisper-medium",
]

_MODULES = {"llama3.2-1b": "llama3_2_1b", "phi3-medium-14b": "phi3_medium_14b",
            "yi-34b": "yi_34b", "command-r-35b": "command_r_35b", "rwkv6-1.6b": "rwkv6_1_6b",
            "zamba2-7b": "zamba2_7b", "mixtral-8x22b": "mixtral_8x22b",
            "kimi-k2-1t-a32b": "kimi_k2_1t_a32b", "qwen2-vl-2b": "qwen2_vl_2b",
            "whisper-medium": "whisper_medium"}


def get_config(arch: str, preset: str = "full"):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    mod = importlib.import_module(f".{_MODULES[arch]}", __package__)
    if preset == "full":
        return mod.full()
    if preset == "smoke":
        return mod.smoke()
    raise ValueError(f"unknown preset {preset!r}")


def for_kernels(cfg):
    """``cfg`` as the card's attention kernels can run it: a head dim they
    are built for is kept; a smaller one (the smoke configs' 16) is widened
    to 64, with ``d_model = n_heads x 64`` and ``d_ff``, the experts'
    ``moe_d_ff`` and the M-RoPE bands (``mrope_sections``, which sum to half
    the head dim) scaled alike, so a smoke run on the card keeps the
    config's depth, heads, experts and vocab."""
    import dataclasses

    from ..kernels.flash_attention.kernel import HEAD_DIMS

    if cfg.head_dim_ in HEAD_DIMS:
        return cfg
    scale = min(HEAD_DIMS) // cfg.head_dim_
    return dataclasses.replace(cfg, head_dim=0, d_model=cfg.n_heads * min(HEAD_DIMS),
                               d_ff=cfg.d_ff * scale, moe_d_ff=cfg.moe_d_ff * scale,
                               mrope_sections=tuple(n * scale for n in cfg.mrope_sections))
