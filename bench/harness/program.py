"""The system under test, as the benchmark reaches it: the port's serving
entry points, its model configuration built from a configuration file, and
its kernel library.  Nothing else of the program is read."""

from __future__ import annotations

import torch

from ..reference.model import Shape
from .spec import capacity_factor, dims_of


def api():
    """``repro_torch.models.serve`` (``init_cache``, ``prefill``,
    ``decode_step``)."""
    from repro_torch.models import serve

    return serve


def build_kernels() -> None:
    """Build (first run in a checkout) or load the port's CUDA kernels."""
    from repro_torch.kernels import _build

    _build.library()


def model_config(config: dict):
    """The port's ``ModelConfig`` for a configuration in its source's keys:
    a dense decoder, or one with a mixture of experts; causal attention over
    every earlier position (``sliding_window`` null) or over a sliding
    window (the port's ``swa_window`` has the Hugging Face meaning of
    ``sliding_window``: a query sees itself and the ``sliding_window - 1``
    keys before it); served in bfloat16."""
    from repro_torch.models.common import ModelConfig

    m = dims_of(config)
    window = (dict(attention="full") if m.window is None
              else dict(attention="swa", swa_window=int(m.window)))
    if config.get("torch_dtype", "bfloat16") != "bfloat16":
        raise ValueError("the benchmark serves in bfloat16")
    extra = {}
    if m.experts:
        extra = dict(n_experts=m.experts, top_k=m.top_k, capacity_factor=capacity_factor(config))
    return ModelConfig(
        arch=config["name"], family="moe" if m.experts else "dense", n_layers=m.layers,
        d_model=m.d, n_heads=m.hq, n_kv_heads=m.hkv, head_dim=m.dh, d_ff=m.f, vocab=m.vocab,
        rope_theta=float(config["rope_theta"]), norm_eps=float(config["rms_norm_eps"]),
        dtype=torch.bfloat16, tie_embeddings=bool(config.get("tie_word_embeddings", False)),
        **window, **extra)


def reference_shape(config: dict) -> Shape:
    m = dims_of(config)
    return Shape(d=m.d, hq=m.hq, hkv=m.hkv, dh=m.dh, vocab=m.vocab, layers=m.layers,
                 experts=m.experts, top_k=m.top_k,
                 capacity_factor=capacity_factor(config) if m.experts else 1.0,
                 rope_theta=float(config["rope_theta"]), eps=float(config["rms_norm_eps"]),
                 window=m.window)
