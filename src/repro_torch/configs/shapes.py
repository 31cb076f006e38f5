"""The assigned input shapes (the port of ``repro/configs/shapes.py``).

  train_4k     seq_len=4096    global_batch=256   (training, train_step)
  prefill_32k  seq_len=32768   global_batch=32    (inference prefill)
  decode_32k   seq_len=32768   global_batch=128   (decode: one new token
                                                   against a 32k cache)
  long_500k    seq_len=524288  global_batch=1     (long-context decode;
                                                   sub-quadratic archs only)

``long_500k`` runs for rwkv6-1.6b (attention-free), zamba2-7b (hybrid SSM)
and mixtral-8x22b (the 4,096-token window bounds decode attention) and is
skipped for the pure full-attention archs.  :func:`input_specs` describes a
cell's inputs as ``device="meta"`` tensors (shape and dtype, no storage),
where the reference returns ``jax.ShapeDtypeStruct``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import get_config
from .qwen2_vl_2b import N_PATCHES

__all__ = ["SHAPES", "ShapeSpec", "input_specs", "cell_inputs", "cell_is_supported",
           "skip_reason"]


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

_SUBQUADRATIC = {"rwkv6-1.6b", "zamba2-7b", "mixtral-8x22b"}


def cell_is_supported(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in _SUBQUADRATIC
    return True


def skip_reason(arch: str, shape: str) -> str | None:
    if cell_is_supported(arch, shape):
        return None
    return (
        f"{arch} is pure full attention: a 500k-token decode cache has no "
        "sub-quadratic path (DESIGN.md §5); long_500k runs only for "
        "SSM/hybrid/SWA archs"
    )


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(arch: str, shape: str) -> dict[str, torch.Tensor]:
    """Every model input of the cell as a meta tensor: the train step's
    batch (``train``), the prompt batch (``prefill``) or the one-token batch
    (``decode``; the cache comes from ``models.serve.init_cache``).  The vlm
    family's sequence holds ``N_PATCHES`` patch embeddings ahead of the
    text, with their M-RoPE position ids; the audio family's train and
    prefill batches add ``frames`` [B, enc_seq, D], the encoder's stub
    input, the tokens being the decoder's."""
    spec = SHAPES[shape]
    return cell_inputs(get_config(arch, "full"), spec.kind, spec.global_batch, spec.seq_len)


def cell_inputs(cfg, kind: str, b: int, s: int) -> dict[str, torch.Tensor]:
    """:func:`input_specs` for any config, kind (train, prefill, decode),
    batch ``b`` and sequence length ``s``."""
    i32 = torch.int32
    if kind == "decode":
        return {"tokens": _meta((b,), i32)}
    if cfg.family == "vlm":
        batch = {"tokens": _meta((b, s - N_PATCHES), i32)}
        if kind == "train":
            batch["labels"] = _meta((b, s - N_PATCHES), i32)
        batch["patch_embeds"] = _meta((b, N_PATCHES, cfg.d_model), cfg.dtype)
        batch["positions_3d"] = _meta((3, b, s), i32)
        return batch
    batch = {"tokens": _meta((b, s), i32)}
    if kind == "train":
        batch["labels"] = _meta((b, s), i32)
    if cfg.family == "audio":
        batch["frames"] = _meta((b, cfg.enc_seq, cfg.d_model), cfg.dtype)
    return batch
