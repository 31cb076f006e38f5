"""The work of the model kernels -- the bytes each call must move and the
operations it must do -- and their face for ``device="meta"`` tensors.

The work functions count what :mod:`chip_smoke`'s kernel table bounds
(every input read once, every output written once; a multiply-add is two
operations) and what the dry-run (``launch/trace_cost.py``) charges, so
the two count the same work:

* :func:`flash_work`: the attention's q / k / v reads and its output
  write; the score and PV products over the pairs a query sees (causal,
  windowed or all of them);
* :func:`decode_work`: one query per head against ``keys`` cached keys;
* :func:`swiglu_work`: x and the three weights read, the output written;
  the three products;
* :func:`moe_experts_work`: the routed experts' SwiGLU over the filled
  slots of a capacity buffer: the filled rows read and written, the
  weights of each expert holding one read once; the filled rows' products;
* :func:`scan_work`: the chunked scans of rwkv6 and Mamba2 (zamba2).

:func:`meta_kernel` is each kernel dispatch's branch for meta inputs: it
returns empty outputs of the kernel's shapes and dtypes and charges the
kernel's work to the active cost trace (none is active outside
``launch/trace_cost.py``'s :class:`~repro_torch.launch.trace_cost.CostTrace`).
It runs no plain version: the plain attention would bill a [B, H, S, S]
float32 score block that the kernel never writes.  Under autograd its
backward returns empty gradients and charges twice the forward's bytes
and operations: it reads what the forward read plus the output's
gradient and writes each input's, and a flash-style backward (or a
SwiGLU's without recomputing the gate) does two products for each of the
forward's.  The card runs these backwards as the plain versions'
autograd today (``kernels/*/grad.py``), so a training cell's kernel terms
are what backward kernels would cost, not what the card spends.
"""

from __future__ import annotations

import torch

__all__ = ["attention_pairs", "flash_work", "decode_keys", "decode_work", "swiglu_work",
           "moe_experts_work", "scan_work", "meta_kernel", "set_tracer"]


def attention_pairs(sq: int, skv: int, causal: bool, window: int | None) -> int:
    """The (query, key) pairs of one head: query ``i`` of ``sq`` (aligned
    to the end of ``skv`` keys) sees ``min(i + 1 + skv - sq, window)`` keys
    when causal, every key otherwise.  Closed form of that sum."""
    if not causal:
        return sq * skv
    w = window or skv
    off = skv - sq + 1  # query i sees i + off keys before the window cuts
    c = min(max(w - off, 0), sq)  # queries the window does not cut
    return c * off + c * (c - 1) // 2 + (sq - c) * w


def flash_work(b: int, hq: int, hkv: int, sq: int, skv: int, dh: int, *, causal: bool = True,
               window: int | None = None, size: int = 2) -> tuple[int, int]:
    """(bytes, operations) of one flash attention call: q and the output
    [B, Hq, Sq, Dh], k and v [B, Hkv, Skv, Dh] in ``size``-byte elements;
    the two products over :func:`attention_pairs`."""
    nbytes = size * b * dh * (2 * sq * hq + 2 * skv * hkv)
    return nbytes, 4 * dh * attention_pairs(sq, skv, causal, window) * b * hq


def decode_keys(s_max: int, window: int | None) -> int:
    """The cached keys a query at the cache's last row reads."""
    return min(s_max, window) if window else s_max


def decode_work(b: int, hq: int, hkv: int, dh: int, keys: int, size: int = 2) -> tuple[int, int]:
    """(bytes, operations) of one decode attention call: q and the output
    [B, Hq, Dh], ``keys`` rows of k and v [B, keys, Hkv, Dh]."""
    nbytes = size * (2 * b * hq * dh + 2 * b * keys * hkv * dh)
    return nbytes, 4 * dh * keys * b * hq


def swiglu_work(t: int, d: int, f: int, size: int = 2) -> tuple[int, int]:
    """(bytes, operations) of one SwiGLU call: x and the output [T, D], the
    gate and up weights [D, F] and the down weight [F, D]."""
    return size * (2 * t * d + 3 * d * f), 6 * t * d * f


def moe_experts_work(counts, d: int, f: int, size: int = 2) -> tuple[int, int]:
    """(bytes, operations) of the routed experts' products over ``counts``
    filled slots an expert: each filled row read and its output written,
    the three weights [D, F] of every expert with a filled slot; the three
    products of each filled row.  Empty slots are no work."""
    filled = sum(counts)
    active = sum(1 for n in counts if n)
    return size * (2 * filled * d + 3 * d * f * active), 6 * filled * d * f


def scan_work(kind: str, b: int, h: int, s: int, dk: int, dv: int, chunk: int, size: int,
              shared_bc: bool = False) -> tuple[int, int, int]:
    """(bytes, operations, product operations) of one scan call: every
    input read once and every output written once, and the operations of
    the chunked form over the causal pairs (a multiply-add counts 2, any
    other op or exp 1), of which the matrix products (cross, weights @ v,
    state update; ssd's C . B) can run on the tensor cores.  zamba2's B and
    C are shared by the heads: they are read, and their C . B products
    formed, once per batch row.  Every full chunk costs the same, so the
    sum takes one full chunk times their count plus the short last one."""
    def per_chunk(c):
        tri = c * (c + 1) // 2  # pairs j <= i
        mma = 2 * c * dk * dv + 2 * tri * dv + 2 * c * dk * dv
        if kind == "rwkv6":  # cross, pair weights (j < i), bonus, att @ v, decays, state
            ops = (2 * c * dk * dv + 5 * (tri - c) * dk + 3 * c * dk + 2 * tri * dv
                   + 4 * c * dk + 2 * c * dk * dv + 3 * dk * dv)
            return ops, 0, mma
        # C . B; its decay weights, cross, att @ x, decays, state
        ops = (3 * tri + 2 * c * dk * dv + 2 * tri * dv + 4 * c * dk + 2 * c * dk * dv
               + 2 * dk * dv)
        return ops, 2 * tri * dk, mma

    full, tail = divmod(s, chunk)
    ops = shared_ops = mma = 0
    for c, n in ((chunk, full), (tail, 1 if tail else 0)):
        o, sh, m = per_chunk(c)
        ops, shared_ops, mma = ops + n * o, shared_ops + n * sh, mma + n * m
    shared_ops *= b * (1 if shared_bc else h)
    ops = b * h * ops + shared_ops
    mma = b * h * mma + shared_ops
    state = 2 * b * h * dk * dv * 4  # s0 in, S_T out (float32)
    if kind == "rwkv6":  # r, k, v, out in the working dtype; lw float32; u
        nbytes = b * h * s * ((2 * dk + 2 * dv) * size + 4 * dk) + h * dk * 4 + state
    else:  # x, y in the working dtype; a float32; B, C
        bc = 2 * b * (1 if shared_bc else h) * s * dk * size
        nbytes = b * h * s * (2 * dv * size + 4) + bc + state
    return nbytes, ops, mma


# --------------------------------------------------------------------------- #
# The meta face
# --------------------------------------------------------------------------- #
_TRACER = None


def set_tracer(tracer):
    """Make ``tracer`` the active cost trace (``None``: none); returns the
    one it replaces.  The trace makes the kernels' outputs:
    ``tracer.kernel(name, dims, inputs, out_specs, backward)`` returns them
    and charges their work."""
    global _TRACER
    prev, _TRACER = _TRACER, tracer
    return prev


def _run(name, dims, inputs, out_specs, backward):
    if _TRACER is not None:
        return _TRACER.kernel(name, dims, inputs, out_specs, backward)
    return tuple(None if spec is None else torch.empty(spec[0], dtype=spec[1], device="meta")
                 for spec in out_specs)


class _MetaKernelFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, name, dims, out_specs, *inputs):
        ctx.name, ctx.dims = name, dims
        ctx.save_for_backward(*inputs)
        return _run(name, dims, inputs, out_specs, False)

    @staticmethod
    def backward(ctx, *grad_outs):
        inputs = ctx.saved_tensors
        specs = [(t.shape, t.dtype) if t is not None and need else None
                 for t, need in zip(inputs, ctx.needs_input_grad[3:])]
        return (None, None, None, *_run(ctx.name, ctx.dims, inputs, specs, True))


def meta_kernel(name: str, inputs: tuple, out_specs: list, dims: dict) -> tuple:
    """Empty meta outputs of ``out_specs`` (``(shape, dtype)`` each) for the
    kernel ``name`` on ``inputs`` (meta tensors or ``None``), its work
    (``dims``: the kernel's sizes) charged to the active cost trace; under
    autograd, through a Function whose backward does the same for the
    inputs' gradients."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
        return _MetaKernelFn.apply(name, dims, out_specs, *inputs)
    return _run(name, dims, inputs, out_specs, False)
