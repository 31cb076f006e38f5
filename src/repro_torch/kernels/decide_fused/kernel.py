"""Wrapper of the CUDA fused decide (``csrc/decide_fused.cu``), the Hopper
counterpart of ``repro/kernels/decide_fused/kernel.py:batch_decide_pallas``.

:func:`plan` picks the route from N: up to 32 operator lanes, the packed
route (scenarios in warp segments of 8 lanes, or of 32 past N = 8; one
warp per block, a j_cap window of T and G per lane);
past 32, the wide route (one block per scenario, whole tables).  Both
routes give the same bits."""

from __future__ import annotations

import torch

from .. import _build

__all__ = ["batch_decide", "plan", "SMEM_LIMIT"]

#: Dynamic shared memory one block may use on the H100 (227 KB) less the
#: wide route's static reduction scratch.
SMEM_LIMIT = 232448 - 32 * 4
_MAX_THREADS = 1024


def plan(n: int, k_hi: int, j_cap: int) -> tuple[int, int, int]:
    """``(segment width, threads per block, shared bytes)`` of the launch
    for ``n`` lanes.  Packed route (``n <= 32``): width 8 up to 8 lanes
    (the fleet's N = 7), else 32; one warp of ``32 // width`` scenarios per
    block, a ``2 j_cap + 1`` float window per thread.  Wide route: width 0,
    one thread per lane padded to whole warps, ``2 k_hi + 1`` table rows
    per thread."""
    if n <= 32:
        return 8 if n <= 8 else 32, 32, (2 * j_cap + 1) * 32 * 4
    threads = -(-n // 32) * 32
    return 0, threads, (2 * k_hi + 1) * threads * 4


def batch_decide(lam, mu_eff, *, group, alpha, active, k_cur, k_max, k_hi: int,
                 j_cap: int | None = None):
    """``[B, N]`` float32 CUDA rates -> ``(k4 i32, k_start i32, t_cur f32,
    t4 f32)``.  ``group`` / ``active`` are bool, ``k_cur`` int32 [B, N],
    ``k_max`` int32 [B]."""
    if lam.ndim != 2:
        raise ValueError(f"lam must be [B, N], got shape {tuple(lam.shape)}")
    b, n = lam.shape
    if k_hi < 1:
        raise ValueError(f"k_hi must be >= 1, got {k_hi}")
    jc = k_hi if j_cap is None else max(min(int(j_cap), k_hi), 1)
    width, threads, smem = plan(n, int(k_hi), jc)
    if threads > _MAX_THREADS:
        raise ValueError(f"batch_decide: N={n} lanes exceed one block ({_MAX_THREADS})")
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"batch_decide: T/G tables need {smem} bytes of shared memory at "
            f"k_hi={k_hi}, j_cap={jc}, N={n}; one H100 block holds {SMEM_LIMIT}"
        )
    dev = lam.device
    for name, t, dt in (("lam", lam, torch.float32), ("mu_eff", mu_eff, torch.float32),
                        ("alpha", alpha, torch.float32), ("group", group, torch.bool),
                        ("active", active, torch.bool), ("k_cur", k_cur, torch.int32)):
        _build.require(f"batch_decide {name}", t, dt, (b, n), device=dev)
    _build.require("batch_decide k_max", k_max, torch.int32, (b,), device=dev)
    lib = _build.library()
    k4 = torch.empty((b, n), dtype=torch.int32, device=dev)
    kst = torch.empty((b, n), dtype=torch.int32, device=dev)
    tcur = torch.empty((b, n), dtype=torch.float32, device=dev)
    t4 = torch.empty((b, n), dtype=torch.float32, device=dev)
    dev_idx, stream = _build.launch_args(lam)
    code = lib.repro_decide_fused(
        lam.data_ptr(), mu_eff.data_ptr(), group.data_ptr(), alpha.data_ptr(),
        active.data_ptr(), k_cur.data_ptr(), k_max.data_ptr(),
        k4.data_ptr(), kst.data_ptr(), tcur.data_ptr(), t4.data_ptr(),
        b, n, int(k_hi), jc, width, threads, dev_idx, stream,
    )
    _build.check_error("batch_decide", code)
    _build.count_launch("decide_fused")
    return k4, kst, tcur, t4
