"""Wrapper of the CUDA RWKV6 scan kernel (``csrc/rwkv6_scan.cu``), the Hopper
counterpart of ``repro/kernels/rwkv6_scan/kernel.py``'s
``rwkv6_scan_pallas``.  Streams are ``[BH]`` as in the TPU kernel or ``[B,
H]``; r / k / v / lw may be strided views (unit last stride), so the
model's ``[B, S, H, D]`` projections pass as ``transpose(1, 2)`` views with
no copy, and a 4-D call returns its output as a ``transpose(1, 2)`` view of
a contiguous ``[B, S, H, Dv]`` buffer.  Any S (the last chunk may be
short)."""

from __future__ import annotations

import torch

from .. import _build

__all__ = ["rwkv6_scan", "MAX_CHUNK", "MAX_DK"]

#: Limits of the kernel's shared-memory plan.
MAX_CHUNK, MAX_DK = 64, 64


def rwkv6_scan(r, k, v, lw, u, s0=None, *, chunk: int = 32):
    """r / k [B, H, S, Dk] or [BH, S, Dk] (CUDA, bf16 or float32, one
    dtype), lw of the same shape in float32, v [..., S, Dv] in r's dtype,
    u broadcastable to [..., Dk] (float32), s0 None (zeros) or a contiguous
    float32 [..., Dk, Dv] -> (o [..., S, Dv] in r's dtype, S_T [..., Dk,
    Dv] float32, contiguous)."""
    if r.ndim not in (3, 4) or k.shape != r.shape or lw.shape != r.shape:
        raise ValueError(f"rwkv6_scan: r {tuple(r.shape)}, k {tuple(k.shape)}, lw "
                         f"{tuple(lw.shape)}: expected one [B, H, S, Dk] or [BH, S, Dk] shape")
    lead, s, dk = r.shape[:-2], r.shape[-2], r.shape[-1]
    dv = v.shape[-1]
    if v.shape[:-1] != r.shape[:-1]:
        raise ValueError(f"rwkv6_scan: v {tuple(v.shape)} does not fit r {tuple(r.shape)}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"rwkv6_scan: chunk {chunk} not in [1, {MAX_CHUNK}]")
    if not 1 <= dk <= MAX_DK or dv < 1 or s < 1 or 0 in lead:
        raise ValueError(f"rwkv6_scan: Dk = {dk} (at most {MAX_DK}), Dv = {dv}, S = {s}, "
                         f"streams {tuple(lead)}: expected non-empty inputs")
    bf16 = _build.require_operands("rwkv6_scan", (r, k, v))
    for name, t in (("lw", lw), ("u", u)):
        if not t.is_cuda or t.device != r.device or t.dtype != torch.float32:
            raise TypeError(f"rwkv6_scan: {name} must be float32 on {r.device}")
    u = torch.broadcast_to(u, (*lead, dk))
    for name, t in (("r", r), ("k", k), ("v", v), ("lw", lw), ("u", u)):
        if t.stride(-1) != 1:
            raise ValueError(f"rwkv6_scan: {name} needs a unit last stride")
    if s0 is not None:
        _build.require("rwkv6_scan s0", s0, torch.float32, (*lead, dk, dv), device=r.device)
    if r.ndim == 3:  # [BH] streams: one batch row of BH heads
        r, k, v, lw, u = (t.unsqueeze(0) for t in (r, k, v, lw, u))
        out = torch.empty((1, lead[0], s, dv), dtype=r.dtype, device=r.device)
    else:
        out = torch.empty((lead[0], s, lead[1], dv), dtype=r.dtype,
                          device=r.device).transpose(1, 2)
    nb, nh = r.shape[0], r.shape[1]
    s_t = torch.empty((*lead, dk, dv), dtype=torch.float32, device=r.device)
    vb = _build.column_slice(nb * nh, dv, r.device)
    strides = [t.stride(i) for t in (r, k, v, lw, out) for i in (0, 1, 2)]
    strides += [u.stride(0), u.stride(1)]
    lib = _build.library()
    dev, stream = _build.launch_args(r)
    code = lib.repro_rwkv6_scan(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(), u.data_ptr(),
        0 if s0 is None else s0.data_ptr(), out.data_ptr(), s_t.data_ptr(), *strides,
        nb, nh, s, dk, dv, int(chunk), vb, int(bf16), dev, stream)
    _build.check_error("rwkv6_scan", code)
    _build.count_launch("rwkv6_scan")
    return (out[0] if len(lead) == 1 else out), s_t
