"""Wrappers of the CUDA l2_match kernels (``csrc/l2_match.cu``), the Hopper
counterparts of ``repro/kernels/l2_match/kernel.py``'s
``pairwise_sq_l2_pallas`` and ``match_count_pallas``.  Any M, N and D: the
kernels mask the ragged tile edges, so nothing is padded.

Both launch one register-tiled kernel on 64 x 64 output tiles, 256 threads
of 4 x 4 outputs, with 16-byte ``cp.async`` copies where D and both bases
allow them (:func:`plan`); ``pairwise_sq_l2`` stores the distances,
``match_count`` counts them.  The copy width never changes the result:
every output sums its depths in order."""

from __future__ import annotations

import torch

from .. import _build
from .ref import squared_threshold

__all__ = ["pairwise_sq_l2", "match_count", "plan"]


def _operands(name, a, b):
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"{name}: expected a [M, D] and b [N, D], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    _build.require(f"{name} a", a, torch.float32)
    _build.require(f"{name} b", b, torch.float32, device=a.device)
    return a.shape[0], b.shape[0], a.shape[1]


def plan(d: int, aligned: bool) -> bool:
    """Whether the kernels stage their operands by 16-byte copies: when
    ``d % 4 == 0`` and both operands start 16-byte ``aligned``; otherwise
    each float is copied alone."""
    return aligned and d % 4 == 0


def pairwise_sq_l2(a, b):
    """a [M, D], b [N, D] float32 CUDA -> [M, N] float32 squared distances."""
    m, n, d = _operands("pairwise_sq_l2", a, b)
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    lib = _build.library()
    dev, stream = _build.launch_args(a)
    vec = plan(d, a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)
    code = lib.repro_pairwise_sq_l2(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, d,
                                    int(vec), dev, stream)
    _build.check_error("pairwise_sq_l2", code)
    _build.count_launch("pairwise_sq_l2")
    return out


def match_count(a, b, threshold: float, valid=None):
    """a [M, D], b [N, D] float32 and valid [M] bool (CUDA) -> int32 [N]:
    per library row, the valid query rows within L2 ``threshold``."""
    m, n, d = _operands("match_count", a, b)
    if valid is None:
        valid = torch.ones(m, dtype=torch.bool, device=a.device)
    _build.require("match_count valid", valid, torch.bool, (m,), device=a.device)
    out = torch.zeros(n, dtype=torch.int32, device=a.device)
    lib = _build.library()
    dev, stream = _build.launch_args(a)
    vec = plan(d, a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)
    code = lib.repro_match_count(a.data_ptr(), b.data_ptr(), valid.data_ptr(),
                                 squared_threshold(threshold), out.data_ptr(), m, n, d,
                                 int(vec), dev, stream)
    _build.check_error("match_count", code)
    _build.count_launch("match_count")
    return out
