"""Architecture configs of the port (``repro/configs``).

``get_config(arch, preset)`` returns a :class:`~repro_torch.models.common
.ModelConfig`: preset ``"full"`` is the published configuration, ``"smoke"``
a reduced one of the same family for CPU tests.  Ported: the dense
family's ``llama3.2-1b``, the ssm family's ``rwkv6-1.6b`` and the hybrid
family's ``zamba2-7b``; every other architecture in :data:`ARCHS` raises
``NotImplementedError`` naming the ROADMAP item that ports it.
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

_MODULES = {"llama3.2-1b": "llama3_2_1b", "rwkv6-1.6b": "rwkv6_1_6b", "zamba2-7b": "zamba2_7b"}

# Where each unported architecture waits (ROADMAP Queue 1 item 5).
_WAITS = {
    "command-r-35b": "dense family beyond llama3.2-1b",
    "yi-34b": "dense family beyond llama3.2-1b",
    "phi3-medium-14b": "dense family beyond llama3.2-1b",
    "qwen2-vl-2b": "vlm family: M-RoPE and patch embeddings",
    "mixtral-8x22b": "moe family: moe_layer and expert parallelism",
    "kimi-k2-1t-a32b": "moe family: moe_layer and expert parallelism",
    "whisper-medium": "audio family: encoder-decoder attention",
}


def get_config(arch: str, preset: str = "full"):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    if arch not in _MODULES:
        raise NotImplementedError(
            f"{arch} is not ported yet ({_WAITS[arch]}; ROADMAP Queue 1 item 5)")
    mod = importlib.import_module(f".{_MODULES[arch]}", __package__)
    if preset == "full":
        return mod.full()
    if preset == "smoke":
        return mod.smoke()
    raise ValueError(f"unknown preset {preset!r}")


def for_kernels(cfg):
    """``cfg`` as the card's attention kernels can run it: a head dim they
    are built for is kept; a smaller one (the smoke configs' 16) is widened
    to 64, with ``d_model = n_heads x 64`` and ``d_ff`` scaled alike, so a
    smoke run on the card keeps the config's depth, heads and vocab."""
    import dataclasses

    from ..kernels.flash_attention.kernel import HEAD_DIMS

    if cfg.head_dim_ in HEAD_DIMS:
        return cfg
    scale = min(HEAD_DIMS) // cfg.head_dim_
    return dataclasses.replace(cfg, head_dim=0, d_model=cfg.n_heads * min(HEAD_DIMS),
                               d_ff=cfg.d_ff * scale)
