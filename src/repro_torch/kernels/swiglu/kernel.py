"""Wrapper of the CUDA SwiGLU kernels (``csrc/swiglu.cu``), the Hopper
counterpart of ``repro/kernels/swiglu/kernel.py``'s ``swiglu_pallas``.

Two products, both counted as ``swiglu``: ``up`` writes the hidden
``h = silu(x Wg) * (x Wu)`` (float32 products, rounded once to x's dtype),
``down`` the product ``h Wo``.  Any T; D and F multiples of 8.

Each product is planned here from host numbers (:func:`plan`): at most
:data:`SMALL_T` rows stream the weights in K slices (enough blocks to
cover the card twice) and sum the slices' float32 partials in slice order
in a second pass; more rows run the tiled GEMM (``wgmma`` + TMA in bf16).
"""

from __future__ import annotations

import torch

from .. import _build

__all__ = ["swiglu", "plan", "split_ranges", "SMALL_T"]

#: Row counts up to this take the weight-streaming path.
SMALL_T = 16
#: Streaming path: output columns per block, K rows per pipeline stage.
STREAM_BN, STREAM_BK = 64, 64
#: Streaming path: blocks to aim for, in multiples of the SM count (bf16,
#: float32); ``tools/kernel_plans.py`` times 2 to 32 at the decode shapes.
STREAM_WAVES = {True: 4, False: 16}
#: Tiled path: block tile (rows, columns) in bf16 and in float32.
GEMM_TILE = {True: (128, 128), False: (64, 64)}


def plan(t: int, n: int, k: int, sms: int, bf16: bool = True) -> dict:
    """Launch plan of one product [t, k] @ [k, n] on a card with ``sms``
    SMs: ``{"path": "stream", "col_tiles", "splits", "kper"}`` (K split
    into ``splits`` slices of ``kper`` rows, a multiple of
    :data:`STREAM_BK`, so that column tiles x slices reaches
    :data:`STREAM_WAVES` x ``sms`` where K allows) or ``{"path": "gemm", "row_tiles", "col_tiles"}``."""
    if t <= SMALL_T:
        col_tiles = -(-n // STREAM_BN)
        k_tiles = -(-k // STREAM_BK)
        want = min(k_tiles, -(-STREAM_WAVES[bf16] * sms // col_tiles))
        per = -(-k_tiles // want)  # k tiles per slice
        return {"path": "stream", "col_tiles": col_tiles, "splits": -(-k_tiles // per),
                "kper": per * STREAM_BK}
    bm, bn = GEMM_TILE[bf16]
    return {"path": "gemm", "row_tiles": -(-t // bm), "col_tiles": -(-n // bn)}


def split_ranges(k: int, splits: int, kper: int) -> list[tuple[int, int]]:
    """The K rows ``[k0, k1)`` of each slice, as the kernel computes them."""
    return [(s * kper, min(k, (s + 1) * kper)) for s in range(splits)]


def _launch(fn, name, p, t, d, f, bf16, ws, dev, stream, ptrs):
    """Launch one product as ``plan`` ``p`` says; ``fn`` takes the call's
    (T, D, F)."""
    splits = p["splits"] if p["path"] == "stream" else 0
    code = fn(*ptrs, 0 if ws is None else ws.data_ptr(), t, d, f,
              p["kper"] if splits else 0, splits, int(bf16), dev, stream)
    _build.check_error(f"swiglu ({name})", code)
    _build.count_launch("swiglu")


def swiglu(x, wg, wu, wo):
    """x [T, D], wg / wu [D, F], wo [F, D] (contiguous CUDA, bf16 or
    float32, one dtype) -> [T, D] in x's dtype."""
    if x.ndim != 2 or wg.ndim != 2:
        raise ValueError("swiglu: expected x [T, D] and 2-D weights")
    t, d = x.shape
    f = wg.shape[1]
    if (tuple(wg.shape) != (d, f) or tuple(wu.shape) != (d, f)
            or tuple(wo.shape) != (f, d)):
        raise ValueError(f"swiglu: x {tuple(x.shape)}, wg {tuple(wg.shape)}, "
                         f"wu {tuple(wu.shape)}, wo {tuple(wo.shape)} do not fit")
    if d % 8 or f % 8 or d == 0 or f == 0:
        raise ValueError(f"swiglu: D = {d} and F = {f} must be positive multiples of 8")
    bf16 = _build.require_operands("swiglu", (x, wg, wu, wo))
    for name, w in (("x", x), ("wg", wg), ("wu", wu), ("wo", wo)):
        if not w.is_contiguous():
            raise ValueError(f"swiglu: {name} must be contiguous")
        if w.data_ptr() % 16:
            raise ValueError(f"swiglu: {name} must be 16-byte aligned")
    h = torch.empty((t, f), dtype=x.dtype, device=x.device)
    out = torch.empty((t, d), dtype=x.dtype, device=x.device)
    lib = _build.library()
    dev, stream = _build.launch_args(x)
    sms = _build.sm_count(dev)
    up, down = plan(t, f, d, sms, bf16), plan(t, d, f, sms, bf16)
    # Split-K partials [splits, products, t, n]: one buffer serves both
    # products (they run in stream order).
    need = max([p["splits"] * nmat * t * n for p, nmat, n in ((up, 2, f), (down, 1, d))
                if p["path"] == "stream" and p["splits"] > 1], default=0)
    ws = torch.empty(need, dtype=torch.float32, device=x.device) if need else None
    _launch(lib.repro_swiglu_up, "up", up, t, d, f, bf16, ws, dev, stream,
            (x.data_ptr(), wg.data_ptr(), wu.data_ptr(), h.data_ptr()))
    _launch(lib.repro_swiglu_down, "down", down, t, d, f, bf16, ws, dev, stream,
            (h.data_ptr(), wo.data_ptr(), out.data_ptr()))
    return out
