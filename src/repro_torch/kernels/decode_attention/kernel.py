"""Wrapper of the CUDA decode attention kernel (``csrc/decode_attention.cu``),
the Hopper counterpart of ``repro/kernels/decode_attention/kernel.py``'s
``decode_attention_pallas``.  Any S_max; GQA with the cache read in place
(never repeated); ``length`` stays on the device, so a decode step needs
no host sync.  Instantiated for llama3.2-1b's attention (head dim 64, four
query heads per KV head) and zamba2-7b's shared MHA block (head dim 112,
one query head per KV head)."""

from __future__ import annotations

import torch

from .. import _build

__all__ = ["decode_attention", "SHAPES"]

#: (head dim, query heads per KV head) pairs the kernel is instantiated for.
SHAPES = ((64, 4), (112, 1))


def decode_attention(q, k_cache, v_cache, length, *, window: int | None = None,
                     scale: float | None = None):
    """q [B, H, Dh], caches [B, S_max, Hkv, Dh] (contiguous CUDA, bf16 or
    float32); ``length`` a 0-dim int32 CUDA tensor -> [B, H, Dh]."""
    if q.ndim != 3 or k_cache.ndim != 4:
        raise ValueError("decode_attention: expected q [B, H, Dh] and caches [B, S, Hkv, Dh]")
    b, h, dh = q.shape
    s_max, hkv = k_cache.shape[1], k_cache.shape[2]
    if tuple(k_cache.shape) != (b, s_max, hkv, dh) or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)} do not fit")
    if window is not None and window < 1:
        raise ValueError(f"decode_attention: window must be >= 1, got {window}")
    bf16 = _build.require_operands("decode_attention", (q, k_cache, v_cache))
    if hkv == 0 or h % hkv or (dh, h // hkv) not in SHAPES:
        raise ValueError(f"decode_attention: head dim {dh} with {h} query heads over {hkv} "
                         f"KV heads (supported (head dim, ratio): {SHAPES})")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be 16-byte aligned")
    _build.require("decode_attention length", length, torch.int32, (), device=q.device)
    out = torch.empty_like(q)
    scale = float(scale) if scale is not None else 1.0 / (dh ** 0.5)
    lib = _build.library()
    dev, stream = _build.launch_args(q)
    code = lib.repro_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), length.data_ptr(),
        out.data_ptr(), b, h, hkv, s_max, dh, scale, int(window or 0), int(bf16), dev, stream)
    _build.check_error("decode_attention", code)
    _build.count_launch("decode_attention")
    return out
