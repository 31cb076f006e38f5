"""Wrapper of the CUDA SSD scan kernel (``csrc/ssd_scan.cu``), the Hopper
counterpart of ``repro/kernels/ssd_scan/kernel.py``'s ``ssd_scan_pallas``.
Streams are ``[BH]`` as in the TPU kernel or ``[B, H]``; every operand may
be a strided view (unit last stride), so the model's ``[B, S, H, Dh]``
input passes as a ``transpose(1, 2)`` view and zamba2's B and C, shared by
all heads, as ``expand``ed views with a zero head stride (read in place:
4 MB per layer at 4 x 4096 instead of a 448 MB copy).  A 4-D call returns
``y`` as a ``transpose(1, 2)`` view of a contiguous ``[B, S, H, Dh]``
buffer.  Any S (the last chunk may be short).

bf16 runs on the tensor cores (``ssd_mma_kernel``) where rows are 16-byte
aligned, Dst is a multiple of 8 and Dh of 16; float32, and bf16 views off
that grid, run the CUDA-core kernel (``ssd_scan_kernel``).  :func:`plan`
picks the launch from host numbers."""

from __future__ import annotations

import torch

from .. import _build

__all__ = ["ssd_scan", "plan", "MAX_CHUNK", "MAX_DST"]

#: Limits of the kernel's shared-memory plan.
MAX_CHUNK, MAX_DST = 64, 64


def plan(nb: int, nh: int, dh: int, dst: int, sms: int, *, tensor_cores: bool,
         shared_bc: bool) -> tuple[int, int]:
    """(heads per block, columns per block) of the tensor-core kernel, or
    (0, None) for the CUDA-core kernel (its columns come from
    :func:`_build.column_slice`).  Two heads share a block -- and their
    C B^T -- where B and C are shared by the heads and that still gives
    every SM a block; otherwise one head, its columns narrowed (64, 32,
    16) until the grid covers the card."""
    if not (tensor_cores and dst % 8 == 0 and dh % 16 == 0):
        return 0, None
    if shared_bc and nh % 2 == 0 and dh % 64 == 0 and nb * nh // 2 * (dh // 64) >= sms:
        return 2, 64
    vb = 64
    while dh % vb:
        vb //= 2
    while vb > 16 and nb * nh * (dh // vb) < sms:
        vb //= 2
    return 1, vb


def ssd_scan(x, a, b, c, s0=None, *, chunk: int = 64):
    """x [B, H, S, Dh] or [BH, S, Dh] (CUDA, bf16 or float32), a [B, H, S]
    / [BH, S] float32 log-decay, b / c [..., S, Dst] in x's dtype, s0 None
    (zeros) or a contiguous float32 [..., Dst, Dh] -> (y [..., S, Dh] in
    x's dtype, S_T [..., Dst, Dh] float32, contiguous)."""
    if x.ndim not in (3, 4) or a.shape != x.shape[:-1]:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, a {tuple(a.shape)}: expected x "
                         "[B, H, S, Dh] or [BH, S, Dh] and a without the last axis")
    lead, s, dh = x.shape[:-2], x.shape[-2], x.shape[-1]
    dst = b.shape[-1]
    if b.shape[:-1] != x.shape[:-1] or c.shape != b.shape:
        raise ValueError(f"ssd_scan: b {tuple(b.shape)}, c {tuple(c.shape)} do not fit x "
                         f"{tuple(x.shape)}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {chunk} not in [1, {MAX_CHUNK}]")
    if not 1 <= dst <= MAX_DST or dh < 1 or s < 1 or 0 in lead:
        raise ValueError(f"ssd_scan: Dst = {dst} (at most {MAX_DST}), Dh = {dh}, S = {s}, "
                         f"streams {tuple(lead)}: expected non-empty inputs")
    bf16 = _build.require_operands("ssd_scan", (x, b, c))
    if not a.is_cuda or a.device != x.device or a.dtype != torch.float32:
        raise TypeError(f"ssd_scan: a must be float32 on {x.device}")
    for name, t in (("x", x), ("b", b), ("c", c)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_scan: {name} needs a unit last stride")
    if s0 is not None:
        _build.require("ssd_scan s0", s0, torch.float32, (*lead, dst, dh), device=x.device)
    if x.ndim == 3:  # [BH] streams: one batch row of BH heads
        x, a, b, c = (t.unsqueeze(0) for t in (x, a, b, c))
        y = torch.empty((1, lead[0], s, dh), dtype=x.dtype, device=x.device)
    else:
        y = torch.empty((lead[0], s, lead[1], dh), dtype=x.dtype,
                        device=x.device).transpose(1, 2)
    nb, nh = x.shape[0], x.shape[1]
    s_t = torch.empty((*lead, dst, dh), dtype=torch.float32, device=x.device)
    strides = [t.stride(i) for t in (x, a, b, c, y) for i in (0, 1, 2)]
    aligned = all(t.data_ptr() % 16 == 0 and all(t.stride(i) % 8 == 0 for i in (0, 1, 2))
                  for t in (x, b, c))
    dev, stream = _build.launch_args(x)
    heads, vb = plan(nb, nh, dh, dst, _build.sm_count(dev), tensor_cores=bf16 and aligned,
                     shared_bc=b.stride(1) == 0 and c.stride(1) == 0)
    if heads == 0:
        vb = _build.column_slice(nb * nh, dh, x.device)
    lib = _build.library()
    code = lib.repro_ssd_scan(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        0 if s0 is None else s0.data_ptr(), y.data_ptr(), s_t.data_ptr(), *strides,
        nb, nh, s, dh, dst, int(chunk), vb, heads, int(bf16), dev, stream)
    _build.check_error("ssd_scan", code)
    _build.count_launch("ssd_scan")
    return (y[0] if len(lead) == 1 else y), s_t
