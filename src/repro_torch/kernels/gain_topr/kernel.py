"""Wrapper of the CUDA top-R selection (``csrc/gain_topr.cu``), the Hopper
counterpart of ``repro/kernels/gain_topr/kernel.py:gain_topr_pallas``."""

from __future__ import annotations

import torch

from .. import _build

__all__ = ["gain_topr"]

_SMEM_DEFAULT = 48 * 1024  # the kernel does not opt in to more


def gain_topr(cand, budget):
    """``cand [B, N, J]`` float32 + ``budget [B]`` int32 (CUDA) -> ``take
    [B, N]`` int32.  Exact on finite gains; equal to the sort-based plain
    version elementwise."""
    if cand.ndim != 3:
        raise ValueError(f"cand must be [B, N, J], got shape {tuple(cand.shape)}")
    b, n, j = cand.shape
    _build.require("gain_topr cand", cand, torch.float32)
    _build.require("gain_topr budget", budget, torch.int32, (b,), device=cand.device)
    lib = _build.library()
    if lib.repro_gain_topr_smem_bytes(n) > _SMEM_DEFAULT:
        raise ValueError(f"gain_topr: N={n} operators exceed the kernel's shared memory")
    take = torch.empty((b, n), dtype=torch.int32, device=cand.device)
    dev, stream = _build.launch_args(cand)
    code = lib.repro_gain_topr(
        cand.data_ptr(), budget.data_ptr(), take.data_ptr(), b, n, j, dev, stream
    )
    _build.check_error("gain_topr", code)
    _build.count_launch("gain_topr")
    return take
