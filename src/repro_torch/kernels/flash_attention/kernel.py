"""Wrapper of the CUDA flash attention kernel (``csrc/flash_attention.cu``),
the Hopper counterpart of ``repro/kernels/flash_attention/kernel.py``'s
``flash_attention_pallas``.  Any Sq and Skv (ragged tiles are masked, not
padded); GQA with ``Hkv`` dividing ``H``; strided views in and out, so the
model's ``[B, S, H, Dh]`` tensors pass as ``transpose(1, 2)`` views with no
copy."""

from __future__ import annotations

import torch

from .. import _build

__all__ = ["attention", "HEAD_DIMS"]

#: Head dims the kernel is instantiated for (llama3.2-1b's 64, zamba2-7b's 112).
HEAD_DIMS = (64, 112)


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              scale: float | None = None):
    """q [B, H, Sq, Dh], k / v [B, Hkv, Skv, Dh] (CUDA, bf16 or float32,
    unit head-dim stride) -> [B, H, Sq, Dh], a ``transpose(1, 2)`` view of a
    contiguous ``[B, Sq, H, Dh]`` buffer."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention: expected 4-D q, k, v [B, H, S, Dh]")
    b, h, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, hkv, skv, dh) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit")
    if hkv == 0 or h % hkv:
        raise ValueError(f"flash_attention: {hkv} KV heads do not divide {h} query heads")
    if causal and sq > skv:
        raise ValueError(f"flash_attention: causal with Sq {sq} > Skv {skv}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    bf16 = _build.require_operands("flash_attention", (q, k, v))
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name} needs a unit head-dim stride")
    out = torch.empty((b, sq, h, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    scale = float(scale) if scale is not None else 1.0 / (dh ** 0.5)
    strides = [t.stride(i) for t in (q, k, v, out) for i in (0, 1, 2)]
    lib = _build.library()
    dev, stream = _build.launch_args(q)
    code = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides,
        b, h, hkv, sq, skv, dh, scale, int(causal), int(window or 0), int(bf16), dev, stream)
    _build.check_error("flash_attention", code)
    _build.count_launch("flash_attention")
    return out
