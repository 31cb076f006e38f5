"""The work of one prefill call's attention block, FFN / MoE block and
routed experts' GEMMs, summed over the layers, from sizes and the kept
pairs alone: the blocks' share of the call in ``prefill_work``'s counts
(``yardstick.py``), each input byte read once and each output byte written
once.  The padded capacity a MoE computes is not counted as work."""

from __future__ import annotations

from .yardstick import (Dims, _expert_bytes, _proj_flops_per_token, attention_pairs,
                        swiglu_work)


def attn_block_work(m: Dims, b: int, s: int, size: int = 2) -> tuple[int, int]:
    """(bytes, operations) of the layers' attention blocks over ``b``
    prompts of ``s`` tokens: the Q, K, V and output projections and the
    attention over the causal pairs (within the window); the projections'
    and the norm's weights, and x [T, D] in and out."""
    t = b * s
    pairs = attention_pairs(s, s, window=m.window)
    flops = t * _proj_flops_per_token(m) + 4 * m.dh * pairs * b * m.hq
    nbytes = size * (m.d * (2 * m.hq * m.dh + 2 * m.hkv * m.dh) + m.d + 2 * t * m.d)
    return m.layers * nbytes, m.layers * flops


def ffn_block_work(m: Dims, t: int, kept_pairs: int | None = None,
                   size: int = 2) -> tuple[int, int]:
    """(bytes, operations) of the layers' FFN blocks over ``t`` tokens: the
    dense SwiGLU and its norm's weight; or the router's product, the kept
    pairs' expert products (``kept_pairs`` summed over the layers), every
    expert's weights, the router's and the norm's, and x [T, D] in and out."""
    if not m.experts:
        nbytes, flops = swiglu_work(t, m.d, m.f, size)
        return m.layers * (nbytes + size * m.d), m.layers * flops
    flops = m.layers * 2 * t * m.d * m.experts + 6 * m.d * m.f * int(kept_pairs)
    nbytes = m.layers * (m.experts * _expert_bytes(m, size)
                         + size * (m.d * m.experts + m.d + 2 * t * m.d))
    return nbytes, flops


def expert_gemm_work(m: Dims, kept_pairs: int, size: int = 2) -> tuple[int, int]:
    """(bytes, operations) of the layers' routed experts' GEMMs: the kept
    pairs' three products (``kept_pairs`` summed over the layers) and every
    expert's weights."""
    return m.layers * m.experts * _expert_bytes(m, size), 6 * m.d * m.f * int(kept_pairs)
