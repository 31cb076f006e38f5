"""The benchmark's yardstick: the published peaks of one NVIDIA H100, the
work of the port's model kernels, and the work of a whole prefill call or
decode step, all counted from sizes alone.

These are frozen copies: the program's own counts (``kernels/cost.py``,
``launch/trace_cost.py``) may change in later changes to the program; these
change only with the benchmark.

Work is counted as the algorithm needs it for the given inputs: every input
byte read once and every output byte written once, a multiply-add as two
operations, attention over the causal pairs only (within the sliding window
where the configuration has one), and a mixture of experts over the (token,
expert) pairs that were kept.
"""

from __future__ import annotations

from dataclasses import dataclass

#: NVIDIA H100 SXM5 80GB data sheet, dense rates at the 700 W limit.
PEAK_FLOPS_BF16 = 989e12  # FLOP/s on the tensor cores
HBM_BW = 3.35e12  # B/s
HBM_BYTES = 80e9


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(nbytes / HBM_BW, flops / PEAK_FLOPS_BF16)


def attention_pairs(sq: int, skv: int, causal: bool = True, window: int | None = None) -> int:
    """The (query, key) pairs one head sees: query ``i`` of ``sq`` (aligned to
    the end of ``skv`` keys) sees ``min(i + 1 + skv - sq, window)`` keys when
    causal, every key otherwise."""
    if not causal:
        return sq * skv
    w = window or skv
    off = skv - sq + 1
    c = min(max(w - off, 0), sq)
    return c * off + c * (c - 1) // 2 + (sq - c) * w


def flash_work(b: int, hq: int, hkv: int, sq: int, skv: int, dh: int, *, causal: bool = True,
               window: int | None = None, size: int = 2) -> tuple[int, int]:
    """(bytes, operations) of one flash attention call: q and the output
    [B, Hq, Sq, Dh] and k / v [B, Hkv, Skv, Dh] once; the score and value
    products over the pairs the queries see."""
    nbytes = size * b * dh * (2 * sq * hq + 2 * skv * hkv)
    return nbytes, 4 * dh * attention_pairs(sq, skv, causal, window) * b * hq


def decode_work(b: int, hq: int, hkv: int, dh: int, keys: int, size: int = 2) -> tuple[int, int]:
    """(bytes, operations) of one decode attention call: q and the output
    [B, Hq, Dh], ``keys`` rows of k and v [B, keys, Hkv, Dh]."""
    nbytes = size * (2 * b * hq * dh + 2 * b * keys * hkv * dh)
    return nbytes, 4 * dh * keys * b * hq


def swiglu_work(t: int, d: int, f: int, size: int = 2) -> tuple[int, int]:
    """(bytes, operations) of one SwiGLU: x and the output [T, D], the gate
    and up weights [D, F] and the down weight [F, D]; three products."""
    return size * (2 * t * d + 3 * d * f), 6 * t * d * f


@dataclass(frozen=True)
class Dims:
    """The sizes of a decoder that the counts need."""

    layers: int
    d: int
    hq: int
    hkv: int
    dh: int
    f: int  # the dense FFN's width, or each expert's
    vocab: int
    experts: int = 0
    top_k: int = 0
    window: int | None = None  # keys a query sees, itself included (None: every earlier one)


def _proj_flops_per_token(m: Dims) -> int:
    return 2 * m.d * (2 * m.hq * m.dh + 2 * m.hkv * m.dh)


def _attn_weight_bytes(m: Dims, size: int) -> int:
    return size * (m.d * (2 * m.hq * m.dh + 2 * m.hkv * m.dh) + 2 * m.d)  # + the two norms


def _expert_bytes(m: Dims, size: int) -> int:
    return size * 3 * m.d * m.f


def prefill_work(m: Dims, b: int, s: int, kept_pairs: int | None = None,
                 size: int = 2) -> tuple[int, int]:
    """(bytes, operations) of one prefill call over ``b`` prompts of ``s``
    tokens with the logits of each prompt's last position.  ``kept_pairs``:
    the (token, expert) pairs the call's MoE layers kept, summed over the
    layers (every expert is read)."""
    t = b * s
    flops = m.layers * (t * _proj_flops_per_token(m)
                        + 4 * m.dh * attention_pairs(s, s, window=m.window) * b * m.hq)
    nbytes = m.layers * _attn_weight_bytes(m, size)
    if m.experts:
        flops += m.layers * 2 * t * m.d * m.experts + 6 * m.d * m.f * int(kept_pairs)
        nbytes += m.layers * (m.experts * _expert_bytes(m, size) + size * m.d * m.experts)
    else:
        flops += m.layers * 6 * t * m.d * m.f
        nbytes += m.layers * _expert_bytes(m, size)
    flops += 2 * b * m.d * m.vocab  # the last positions' logits
    nbytes += size * m.d * m.vocab + size * m.d  # the output head and the final norm
    nbytes += size * t * m.d + 8 * t  # the embedding rows gathered; the tokens
    nbytes += size * m.layers * 2 * t * m.hkv * m.dh  # the cache written
    nbytes += size * b * m.vocab  # the logits written
    return nbytes, flops


def decode_step_work(m: Dims, b: int, keys: int, kept_pairs: int | None = None,
                     experts_read: int | None = None, size: int = 2) -> tuple[int, int]:
    """(bytes, operations) of one decode step of ``b`` sequences, each
    attending over ``keys`` cached rows (its new one included; at most the
    window's).
    ``kept_pairs``: the (token, expert) pairs kept, summed over the layers;
    ``experts_read``: the experts that received a kept pair, summed over the
    layers (only their weights must be read)."""
    keys = min(keys, m.window or keys)
    flops = m.layers * (b * _proj_flops_per_token(m) + 4 * m.dh * keys * b * m.hq)
    nbytes = m.layers * _attn_weight_bytes(m, size)
    if m.experts:
        flops += m.layers * 2 * b * m.d * m.experts + 6 * m.d * m.f * int(kept_pairs)
        nbytes += int(experts_read) * _expert_bytes(m, size) + m.layers * size * m.d * m.experts
    else:
        flops += m.layers * 6 * b * m.d * m.f
        nbytes += m.layers * _expert_bytes(m, size)
    flops += 2 * b * m.d * m.vocab
    nbytes += size * m.d * m.vocab + size * m.d
    nbytes += size * b * m.d + 8 * b
    nbytes += size * m.layers * 2 * b * keys * m.hkv * m.dh  # the cache rows read
    nbytes += size * m.layers * 2 * b * m.hkv * m.dh  # the new rows written
    nbytes += size * b * m.vocab
    return nbytes, flops
