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

__all__ = ["SHAPES", "ShapeSpec", "input_specs", "cell_is_supported", "skip_reason"]


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
    (``decode``; the cache comes from ``models.serve.init_cache``).  Raises
    ``NotImplementedError`` for an architecture the port does not run (the
    vlm and audio families' extra inputs come with those families, ROADMAP
    Queue 1 item 5)."""
    get_config(arch, "full")  # raises for an architecture the port does not run
    spec = SHAPES[shape]
    b, s = spec.global_batch, spec.seq_len
    i32 = torch.int32
    if spec.kind == "train":
        return {"tokens": _meta((b, s), i32), "labels": _meta((b, s), i32)}
    if spec.kind == "prefill":
        return {"tokens": _meta((b, s), i32)}
    return {"tokens": _meta((b,), i32)}
