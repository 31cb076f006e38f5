"""SSM blocks: the RWKV6 "Finch" WKV recurrence and the Mamba2 SSD
recurrence (the port of ``repro/models/ssm.py``).

``rwkv6_chunked`` / ``ssd_chunked`` are the plain chunked versions in the
model's layout (``[B, S, H, D]``): they loop over chunks with a float32
state through the scan kernels' plain versions
(``kernels/{rwkv6,ssd}_scan/ref.py``), whose intra-chunk weights are
differences of cumulative log-decays (at most 1).  The reference's
``e^{-pc}`` factor overflows float32 once a chunk's decay passes e^-88, so
where the reference is finite the two agree up to rounding and elsewhere
only the port is finite.  The model layers call the scan kernels through
their dispatch (``ops``) instead: only the tests call these two, as the
model-layout reference held against the JAX package's functions of the
same names.

``rwkv6_step`` / ``ssd_step`` are the single-token recurrences of the
decode path, plain PyTorch (no TPU kernel backs them).
"""

from __future__ import annotations

import torch

from ..kernels.rwkv6_scan import ref as rwkv6_ref
from ..kernels.ssd_scan import ref as ssd_ref

__all__ = ["rwkv6_chunked", "rwkv6_step", "ssd_chunked", "ssd_step"]


def rwkv6_chunked(r, k, v, w, u, *, chunk: int = 32, initial_state=None):
    """r / k / w [B, S, H, Dk] (w the decay in (0, 1)), v [B, S, H, Dv], u
    [H, Dk] -> (out [B, S, H, Dv] in r's dtype, final state [B, H, Dk, Dv]
    float32)."""
    lw = torch.log(torch.clamp(w.to(torch.float32), 1e-8, 1.0))
    out, state = rwkv6_ref.rwkv6_scan(
        r.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), lw.transpose(1, 2),
        u.to(torch.float32), initial_state, chunk=chunk)
    return out.transpose(1, 2), state


def rwkv6_step(r, k, v, w, u, state):
    """Single-token WKV6: r / k / w [B, H, Dk], v [B, H, Dv], u [H, Dk],
    state [B, H, Dk, Dv] -> (out [B, H, Dv] in r's dtype, new state)."""
    f32 = torch.float32
    rf, kf, vf, wf = (x.to(f32) for x in (r, k, v, w))
    kv = kf[..., :, None] * vf[..., None, :]  # [B, H, Dk, Dv]
    out = torch.einsum("bhk,bhkv->bhv", rf, state + u.to(f32)[None, ..., None] * kv)
    new_state = wf[..., None] * state + kv
    return out.to(r.dtype), new_state


def ssd_chunked(x, a, bmat, cmat, *, chunk: int = 64, initial_state=None):
    """x [B, S, H, Dh] (dt-scaled input), a [B, S, H] (log-decay <= 0),
    bmat / cmat [B, S, H, Dst] -> (y [B, S, H, Dh] in x's dtype, state [B,
    H, Dst, Dh] float32)."""
    y, state = ssd_ref.ssd_scan(
        x.transpose(1, 2), a.to(torch.float32).transpose(1, 2), bmat.transpose(1, 2),
        cmat.transpose(1, 2), initial_state, chunk=chunk)
    return y.transpose(1, 2), state


def ssd_step(x, a, bvec, cvec, state):
    """Single-token SSD: x [B, H, Dh], a [B, H], bvec / cvec [B, H, Dst],
    state [B, H, Dst, Dh] -> (y [B, H, Dh] in x's dtype, new state)."""
    f32 = torch.float32
    xf, af, bf, cf = (t.to(f32) for t in (x, a, bvec, cvec))
    new_state = torch.exp(af)[..., None, None] * state + bf[..., :, None] * xf[..., None, :]
    y = torch.einsum("bhs,bhsd->bhd", cf, new_state)
    return y.to(x.dtype), new_state
