"""int8 gradient compression with per-tensor scales (the port of
``repro/distributed/compress.py``): symmetric absmax quantisation of each
gradient leaf to int8 before the cross-replica reduction consumes it, 2x
fewer bytes than bf16 and 4x fewer than float32.  Absmax int8 keeps ~48 dB
of SNR per tensor; :func:`compress_with_feedback` carries each step's
quantisation error into the next (error feedback), which keeps the
accumulated error bounded.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..tree import tree_map

__all__ = ["CompressedTensor", "ErrorFeedbackState", "compress", "decompress",
           "compress_tree", "decompress_tree", "compress_with_feedback"]


class CompressedTensor(NamedTuple):
    q: torch.Tensor  # int8 payload
    scale: torch.Tensor  # [] float32 absmax / 127


def _is_compressed(x) -> bool:
    return isinstance(x, CompressedTensor)


def compress(x: torch.Tensor) -> CompressedTensor:
    x32 = x.to(torch.float32)
    scale = torch.clamp_min(x32.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return CompressedTensor(q, scale)


def decompress(c: CompressedTensor, dtype=torch.float32) -> torch.Tensor:
    return (c.q.to(torch.float32) * c.scale).to(dtype)


def compress_tree(tree: Any) -> Any:
    return tree_map(compress, tree)


def decompress_tree(tree: Any) -> Any:
    return tree_map(decompress, tree, is_leaf=_is_compressed)


class ErrorFeedbackState(NamedTuple):
    residual: Any  # tree of float32 residuals


def compress_with_feedback(tree: Any, ef: ErrorFeedbackState | None
                           ) -> tuple[Any, ErrorFeedbackState]:
    """Quantise (g + residual) and keep the quantisation error as the next
    residual."""
    if ef is None:
        ef = ErrorFeedbackState(tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                                         tree))
    carried = tree_map(lambda g, r: g.to(torch.float32) + r, tree, ef.residual)
    comp = compress_tree(carried)
    deq = decompress_tree(comp)
    return comp, ErrorFeedbackState(tree_map(lambda c, d: c - d, carried, deq))
