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

One launch per call (``decode_tma_kernel``: cache tiles fed by TMA, a GQA
group's products on ``mma.sync``, MHA's heads read in pairs where their
count is even).  The B * Hkv groups' valid rows, flattened group by
group, are cut into equal contiguous ranges, one per block of a host-known
grid (:data:`BLOCKS_PER_SM` times the SMs); a range may cross from one
group into the next.  Each block computes its range from the device
``length`` (:func:`segments` mirrors the formula, :func:`valid_range` the
rows), so the step stays free of host syncs and capturable in a CUDA
graph.  A group split over several blocks is merged by the last of them
from float32 partials, in block order; its counter and the partials live
in buffers kept here per (device, stream) across calls (:func:`_scratch`),
allocated (the counters zeroed) only when a call needs more than the last
one: calls on one stream are ordered, and the merging block leaves its
counter at 0 for the next call.
"""

from __future__ import annotations

import threading

import torch

from .. import _build

__all__ = ["decode_attention", "SHAPES", "valid_range", "segments"]

#: (head dim, query heads per KV head) pairs the kernel is instantiated for.
SHAPES = ((64, 1), (64, 2), (64, 3), (64, 4), (64, 7), (64, 8), (112, 1), (112, 8), (128, 4),
          (128, 6), (128, 7), (128, 8))
#: Blocks per SM of the grid: one wave.  ``tools/kernel_plans.py decode``
#: timed 1-4; more split a short call's groups into more partials and ran
#: no faster on the long ones.
BLOCKS_PER_SM = 1


def valid_range(length: int, s_max: int, window: int | None) -> tuple[int, int]:
    """The cache rows ``[lo, hi)`` the kernel reads: the valid prefix (and
    window), or all ``s_max`` rows with equal weights where that is empty
    (the reference's softmax over all ``-1e30`` logits)."""
    hi = min(length, s_max)
    lo = max(0, length - window) if window else 0
    return (0, s_max) if hi <= lo else (lo, hi)


def segments(groups: int, rows: int, grid: int, block: int) -> list[tuple[int, int, int, int,
                                                                          bool]]:
    """Block ``block``'s share of ``groups`` x ``rows`` valid rows over a
    ``grid`` of blocks, as ``decode_tma_kernel`` computes it (``Share``):
    the flattened work cut into ranges of ``ceil(groups * rows / grid)``
    rows.  Returns (group, first row, end row, workspace slot, whole) for
    each group the range meets, rows counted from the valid range's start;
    ``whole``: the block holds all of the group's rows and writes its output
    (else its partial goes to slot 0 for its first group, 1 for its last)."""
    work = groups * rows
    chunk = -(-work // grid)
    w0, w1 = block * chunk, min(work, (block + 1) * chunk)
    out = []
    if w0 >= w1:
        return out
    for g in range(w0 // rows, (w1 - 1) // rows + 1):
        base = g * rows
        whole = base // chunk == (base + rows - 1) // chunk
        out.append((g, max(w0, base) - base, min(w1, base + rows) - base,
                    0 if g == w0 // rows else 1, whole))
    return out


_buffers: dict = {}  # (device index, stream) -> (partials float32, counters int32)
_buffers_lock = threading.Lock()


def _scratch(device, stream: int, floats: int, groups: int):
    """The workspace of partials (at least ``floats``) and the group
    counters (at least ``groups``, zero between calls) for calls on
    ``stream``; reallocated only when a call needs more."""
    key = (device.index, stream)
    with _buffers_lock:
        part, count = _buffers.get(key, (None, None))
        if part is None or part.numel() < floats:
            part = torch.empty(floats, dtype=torch.float32, device=device)
        if count is None or count.numel() < groups:
            count = torch.zeros(groups, dtype=torch.int32, device=device)
        _buffers[key] = (part, count)
    return part, count


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
    if s_max == 0:  # no cache row: every softmax is empty and every output 0
        return torch.zeros_like(q)
    if b * hkv * s_max >= 2 ** 31:  # the kernel's partition counts rows in 32 bits
        raise ValueError(f"decode_attention: {b} x {hkv} x {s_max} cache rows exceed 2^31 - 1")
    dev, stream = _build.launch_args(q)
    n_rep = h // hkv
    grid = BLOCKS_PER_SM * _build.sm_count(dev)
    out = torch.empty_like(q)
    # two slots a block of (query rows a group) x (dh + 2): MHA runs heads in pairs
    part, count = _scratch(q.device, stream, 2 * grid * max(n_rep, 2) * (dh + 2), b * hkv)
    scale = float(scale) if scale is not None else 1.0 / (dh ** 0.5)
    code = _build.library().repro_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), length.data_ptr(),
        out.data_ptr(), part.data_ptr(), count.data_ptr(), b, h, hkv, s_max, dh, grid, scale,
        int(window or 0), int(bf16), dev, stream)
    _build.check_error("decode_attention", code)
    _build.count_launch("decode_attention")
    return out
