"""Wrapper of the CUDA Erlang-B table (``csrc/erlang_c.cu``), the Hopper
counterpart of ``repro/kernels/erlang_c/kernel.py:erlang_b_table_pallas``."""

from __future__ import annotations

import torch

from .. import _build

__all__ = ["erlang_b_table"]


def erlang_b_table(a, *, k_hi: int):
    """[S] float32 CUDA offered loads -> [k_hi+1, S] float32 table."""
    if a.ndim != 1:
        raise ValueError(f"a must be 1-D, got shape {tuple(a.shape)}")
    if k_hi < 0:
        raise ValueError(f"k_hi must be >= 0, got {k_hi}")
    _build.require("erlang_b_table a", a, torch.float32)
    out = torch.empty((k_hi + 1, a.shape[0]), dtype=torch.float32, device=a.device)
    lib = _build.library()
    dev, stream = _build.launch_args(a)
    code = lib.repro_erlang_b_table(
        a.data_ptr(), out.data_ptr(), a.shape[0], int(k_hi), dev, stream
    )
    _build.check_error("erlang_b_table", code)
    _build.count_launch("erlang_c")
    return out
