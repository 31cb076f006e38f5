"""Wrapper of the grouped CUDA kernels of the routed experts
(``csrc/moe_experts.cu``).

Two launches, both counted as ``moe_experts``: ``up`` writes the hidden
``h [E, C, F] = silu(x Wg) * (x Wu)`` of every row tile of
:data:`ROW_TILE` slots that holds a filled slot, ``down`` the product
``h Wo [E, C, D]`` over the same tiles.  ``counts`` [E] (int32, on the
card) says how many of each expert's slots are filled; the kernels read
it there, so the host launches both products without waiting for the
routing.  Rows of the tiles not run are left as ``torch.empty`` made them:
the caller reads only filled slots.  The rounding is
``models/ffn.py:_experts``'s, step for step (``ref.py``).
"""

from __future__ import annotations

import torch

from .. import _build

__all__ = ["MIN_SLOTS", "ROW_TILE", "experts", "run_rows"]

#: Slots of one expert per block: the kernels' row tile.
ROW_TILE = 128

#: The fewest slots an expert (the capacity) at which ``models/ffn.py``
#: takes these kernels: more than two row tiles.  The kernels compute whole
#: 128-row tiles, so an expert whose count passes a tile by a few rows costs
#: a whole tile more, against ``torch.bmm``'s products over exactly the
#: capacity; that rounding costs as much as the skipped rows save until the
#: capacity spans a few tiles.  Measured on an H100 (700 W), the kernels'
#: time over the padded ``bmm`` products' at full width, uniform routing
#: (``tools/kernel_plans.py moe_experts``, three runs): mixtral-8x22b,
#: every expert filled, 1.03-1.04 at 5 slots and 1.02-1.03 at 20 (one
#: tile: the weights' bytes bound both, and only an empty expert is saved),
#: 0.98-0.99 at 80, 0.93 at 120 and 130, 1.06-1.09 at 160 (half the experts
#: past one tile), 0.98-1.01 at 320, 0.69-0.70 at the prefill cell's 5,120;
#: kimi-k2 (384 experts) 0.99 at 6 slots, 0.98 at 26, 0.90-0.91 at 106,
#: 0.88-0.89 at 133, 0.89-0.93 at its 4 x 4,096 prefill's 426.  A step of
#: a few tokens where experts go empty gains more (0.81 at mixtral's 1 slot
#: with 6 of 8 experts filled, 0.09 at kimi's with 32 of 384), but which
#: experts are empty is known only on the card.
MIN_SLOTS = 2 * ROW_TILE + 1


def run_rows(counts: torch.Tensor, cap: int) -> torch.Tensor:
    """[E]: the buffer rows inside the row tiles that the kernels run for
    ``counts`` filled slots an expert (``ceil(count / ROW_TILE)`` tiles,
    cut at the capacity ``cap``)."""
    return ((counts + ROW_TILE - 1) // ROW_TILE * ROW_TILE).clamp(max=cap)


def experts(buf, wg, wu, wo, counts):
    """buf [E, C, D], wg / wu [E, D, F], wo [E, F, D] (contiguous bf16 CUDA
    tensors on one device), counts [E] int32 on that device -> [E, C, D]
    bf16: each expert's SwiGLU on the rows of its counted tiles."""
    if buf.ndim != 3 or wg.ndim != 3:
        raise ValueError("moe_experts: expected buf [E, C, D] and 3-D weights")
    e, c, d = buf.shape
    f = wg.shape[2]
    if (tuple(wg.shape) != (e, d, f) or tuple(wu.shape) != (e, d, f)
            or tuple(wo.shape) != (e, f, d)):
        raise ValueError(f"moe_experts: buf {tuple(buf.shape)}, wg {tuple(wg.shape)}, "
                         f"wu {tuple(wu.shape)}, wo {tuple(wo.shape)} do not fit")
    if d % 8 or f % 8 or d == 0 or f == 0:
        raise ValueError(f"moe_experts: D = {d} and F = {f} must be positive multiples of 8")
    if not _build.require_operands("moe_experts", (buf, wg, wu, wo)):
        raise TypeError(f"moe_experts: the kernels take bfloat16, got {buf.dtype}")
    for name, w in (("buf", buf), ("wg", wg), ("wu", wu), ("wo", wo)):
        if not w.is_contiguous():
            raise ValueError(f"moe_experts: {name} must be contiguous")
        if w.data_ptr() % 16:
            raise ValueError(f"moe_experts: {name} must be 16-byte aligned")
    _build.require("moe_experts: counts", counts, torch.int32, (e,), device=buf.device)
    h = torch.empty((e, c, f), dtype=buf.dtype, device=buf.device)
    out = torch.empty_like(buf)
    lib = _build.library()
    dev, stream = _build.launch_args(buf)
    _build.check_error("moe_experts (up)", lib.repro_moe_experts_up(
        buf.data_ptr(), wg.data_ptr(), wu.data_ptr(), h.data_ptr(), counts.data_ptr(), e, c, d,
        f, dev, stream))
    _build.count_launch("moe_experts")
    _build.check_error("moe_experts (down)", lib.repro_moe_experts_down(
        h.data_ptr(), wo.data_ptr(), out.data_ptr(), counts.data_ptr(), e, c, d, f, dev, stream))
    _build.count_launch("moe_experts")
    return out
