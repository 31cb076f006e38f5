"""Wrapper of the CUDA SwiGLU kernels (``csrc/swiglu.cu``), the Hopper
counterpart of ``repro/kernels/swiglu/kernel.py``'s ``swiglu_pallas``.

Two launches, both counted as ``swiglu``: ``up`` writes the hidden
``h = silu(x Wg) * (x Wu)`` (float32 products, rounded once to x's dtype),
``down`` the product ``h Wo``.  Any T; D and F multiples of 8."""

from __future__ import annotations

import torch

from .. import _build

__all__ = ["swiglu"]


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
    code = lib.repro_swiglu_up(x.data_ptr(), wg.data_ptr(), wu.data_ptr(), h.data_ptr(),
                               t, d, f, int(bf16), dev, stream)
    _build.check_error("swiglu (up)", code)
    _build.count_launch("swiglu")
    code = lib.repro_swiglu_down(h.data_ptr(), wo.data_ptr(), out.data_ptr(), t, d, f,
                                 int(bf16), dev, stream)
    _build.check_error("swiglu (down)", code)
    _build.count_launch("swiglu")
    return out
