"""Wrapper of the CUDA decode attention kernel (``csrc/decode_attention.cu``),
the Hopper counterpart of ``repro/kernels/decode_attention/kernel.py``'s
``decode_attention_pallas``.  Any S_max; GQA with the cache read in place
(never repeated); ``length`` stays on the device, so a decode step needs
no host sync.  Instantiated for llama3.2-1b's attention (head dim 64, four
query heads per KV head), whisper-medium's self and cross attention (head
dim 64, MHA: one), zamba2-7b's shared MHA block (head dim 112, one
query head per KV head), phi3-medium-14b, yi-34b and command-r-35b (head
dim 128; 4, 7 and 8 query heads per KV head), mixtral-8x22b and
qwen2-vl-2b (head dim 128, 6), kimi-k2-1t-a32b (head dim 112, 8), and the
smoke configs as ``configs.for_kernels`` widens them (head dim 64; 2, 3,
7, 8).

Split-KV: the cache of each (sequence, KV head) is cut into ``n_splits``
slices, one block each, and a combine pass merges their partials.  The
number of splits comes from host-known numbers only (:func:`split_plan`);
each block computes its own slice from the device ``length``
(:func:`split_range`, the formula the kernel carries), so the step stays
free of host syncs and capturable in a CUDA graph.  The float32 partials
live in a workspace allocated here.
"""

from __future__ import annotations

import functools

import torch

from .. import _build

__all__ = ["decode_attention", "SHAPES", "split_plan", "valid_range", "split_range",
           "rows_per_step"]

#: (head dim, query heads per KV head) pairs the kernel is instantiated for.
SHAPES = ((64, 1), (64, 2), (64, 3), (64, 4), (64, 7), (64, 8), (112, 1), (112, 8), (128, 4),
          (128, 6), (128, 7), (128, 8))

#: Fewest cache rows worth a split of their own.
MIN_SPLIT_ROWS = 256
#: Most splits per (sequence, KV head): bounds the workspace.
MAX_SPLITS = 64
# The split kernel's block: warps and rows per lane group per step.
_WARPS, _UNROLL = 4, 4


def split_plan(b: int, hkv: int, s_max: int, slots: int) -> int:
    """Splits per (sequence, KV head): as many as fill the ``slots`` blocks
    the card runs at once (one wave: equal slices end together) over the
    ``b * hkv`` groups, at most one per ``MIN_SPLIT_ROWS`` cache rows and at
    most ``MAX_SPLITS``; at least 1."""
    n = slots // max(1, b * hkv)
    return max(1, min(n, s_max // MIN_SPLIT_ROWS, MAX_SPLITS))


def rows_per_step(dh: int, itemsize: int) -> int:
    """Cache rows one split-kernel block reads per step (``Rows::kStep``):
    a row is ``dh * itemsize / 16`` lanes of 16-byte loads, spanning the
    next power of two; a warp reads ``32 / span`` rows at once, four deep."""
    lanes = dh * itemsize // 16
    span = 1 << (lanes - 1).bit_length()
    return _WARPS * (32 // span) * _UNROLL


def valid_range(length: int, s_max: int, window: int | None) -> tuple[int, int]:
    """The cache rows ``[lo, hi)`` the kernel reads: the valid prefix (and
    window), or all ``s_max`` rows with equal weights where that is empty
    (the reference's softmax over all ``-1e30`` logits)."""
    hi = min(length, s_max)
    lo = max(0, length - window) if window else 0
    return (0, s_max) if hi <= lo else (lo, hi)


def split_range(lo: int, hi: int, n_splits: int, step: int, split: int) -> tuple[int, int]:
    """Split ``split``'s rows of ``[lo, hi)``: ``ceil((hi - lo) / n_splits)``
    rounded up to ``step`` rows each, the last ones short or empty.  The
    kernel computes the same on the device (``decode_split_kernel``)."""
    chunk = -(-(hi - lo) // n_splits)
    chunk = -(-chunk // step) * step
    s_lo = min(hi, lo + split * chunk)
    return s_lo, min(hi, s_lo + chunk)


@functools.lru_cache(maxsize=None)
def _slots(index: int, dh: int, n_rep: int, bf16: bool) -> int:
    """Split-kernel blocks device ``index`` runs at once: the blocks one SM
    holds (CUDA's occupancy calculator on the built kernel) times the SMs."""
    import ctypes

    per_sm = ctypes.c_int(0)
    code = _build.library().repro_decode_attention_blocks_per_sm(
        dh, n_rep, int(bf16), index, ctypes.byref(per_sm))
    _build.check_error("decode_attention", code)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return max(1, per_sm.value) * sms


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
    dev, stream = _build.launch_args(q)
    n_splits = split_plan(b, hkv, s_max, _slots(dev, dh, h // hkv, bf16))
    out = torch.empty_like(q)
    parts = b * h * n_splits
    work = torch.empty(parts * (dh + 2), dtype=torch.float32, device=q.device)
    scale = float(scale) if scale is not None else 1.0 / (dh ** 0.5)
    lib = _build.library()
    code = lib.repro_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), length.data_ptr(),
        out.data_ptr(), work.data_ptr(), work.data_ptr() + parts * dh * 4, b, h, hkv, s_max,
        dh, n_splits, scale, int(window or 0), int(bf16), dev, stream)
    _build.check_error("decode_attention", code)
    _build.count_launch("decode_attention")
    return out
