"""Wrapper of the CUDA top-R selection (``csrc/gain_topr.cu``), the Hopper
counterpart of ``repro/kernels/gain_topr/kernel.py:gain_topr_pallas``.

:func:`plan` picks the route from the tile's shape: up to 32 operators and
:data:`WARP_MAX_ELEMS` gains per scenario, the warp route (one warp per
scenario, the tile in registers); past either, the block route (one
256-thread block per scenario).  Both give the same takes."""

from __future__ import annotations

import torch

from .. import _build

__all__ = ["gain_topr", "plan", "WARP_MAX_ELEMS"]

_SMEM_DEFAULT = 48 * 1024  # the block route does not opt in to more
#: The warp route's register budget: 32 lanes x 16 values (e.g. 32 x 16).
WARP_MAX_ELEMS = 512


def plan(n: int, j: int) -> tuple[str, int]:
    """``(route, slots)`` for an ``[n, j]`` tile: the warp route (radix
    select) with ``slots`` = 4 ceil(n j / 128) registers per lane (at
    least 4), or ``("block", 0)`` (bisection)."""
    e = n * j
    if n <= 32 and e <= WARP_MAX_ELEMS:
        return "warp", max(4, 4 * -(-e // 128))
    return "block", 0


def gain_topr(cand, budget):
    """``cand [B, N, J]`` float32 + ``budget [B]`` int32 (CUDA) -> ``take
    [B, N]`` int32, equal to the sort-based plain version elementwise."""
    if cand.ndim != 3:
        raise ValueError(f"cand must be [B, N, J], got shape {tuple(cand.shape)}")
    b, n, j = cand.shape
    _build.require("gain_topr cand", cand, torch.float32)
    _build.require("gain_topr budget", budget, torch.int32, (b,), device=cand.device)
    route, slots = plan(n, j)
    lib = _build.library()
    if route == "block" and lib.repro_gain_topr_smem_bytes(n) > _SMEM_DEFAULT:
        raise ValueError(f"gain_topr: N={n} operators exceed the kernel's shared memory")
    take = torch.empty((b, n), dtype=torch.int32, device=cand.device)
    dev, stream = _build.launch_args(cand)
    code = lib.repro_gain_topr(
        cand.data_ptr(), budget.data_ptr(), take.data_ptr(), b, n, j,
        int(route == "warp"), slots, dev, stream,
    )
    _build.check_error("gain_topr", code)
    _build.count_launch("gain_topr")
    return take
