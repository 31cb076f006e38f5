"""Seeded weights in the port's parameter layout, drawn on the device.

The same tensors go to the program and to the reference.  Layout (the
port's stacked ``[L, ...]`` leaves): ``embed`` [V, D], ``lm_head`` [D, V],
``final_norm`` [D]; under ``layers``: ``attn_norm`` / ``ffn_norm`` [L, D],
``wq`` [L, D, Hq Dh], ``wk`` / ``wv`` [L, D, Hkv Dh], ``wo`` [L, Hq Dh, D];
the dense FFN's ``wi_gate`` / ``wi_up`` [L, D, F] and ``wo_ffn`` [L, F, D],
or the MoE's ``router`` [L, D, E], ``moe_wi_gate`` / ``moe_wi_up`` [L, E, D,
F] and ``moe_wo`` [L, E, F, D].  Matrices are normal times 1 / sqrt(fan in)
(the embedding times 0.02), norm weights uniform in [0.75, 1.25] so that a
norm that drops its weight shows.  One call a leaf, in the served dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from .yardstick import Dims


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one of a run's random streams (0: weights, 1:
    traffic, 2: the check's sample), from ``--seed``."""
    return int(np.random.SeedSequence([int(seed), stream]).generate_state(1, np.uint64)[0] >> 1)


def layout(m: Dims) -> dict:
    """Every leaf's (shape, kind, scale)."""
    L, d, qd, kd = m.layers, m.d, m.hq * m.dh, m.hkv * m.dh
    layers = {
        "attn_norm": ((L, d), "norm", None),
        "wq": ((L, d, qd), "normal", d ** -0.5),
        "wk": ((L, d, kd), "normal", d ** -0.5),
        "wv": ((L, d, kd), "normal", d ** -0.5),
        "wo": ((L, qd, d), "normal", qd ** -0.5),
        "ffn_norm": ((L, d), "norm", None),
    }
    if m.experts:
        e, f = m.experts, m.f
        layers.update(router=((L, d, e), "normal", d ** -0.5),
                      moe_wi_gate=((L, e, d, f), "normal", d ** -0.5),
                      moe_wi_up=((L, e, d, f), "normal", d ** -0.5),
                      moe_wo=((L, e, f, d), "normal", f ** -0.5))
    else:
        layers.update(wi_gate=((L, d, m.f), "normal", d ** -0.5),
                      wi_up=((L, d, m.f), "normal", d ** -0.5),
                      wo_ffn=((L, m.f, d), "normal", m.f ** -0.5))
    return {"embed": ((m.vocab, d), "normal", 0.02), "lm_head": ((d, m.vocab), "normal", d ** -0.5),
            "final_norm": ((d,), "norm", None), "layers": layers}


def draw(m: Dims, seed: int, device, dtype=torch.bfloat16) -> dict:
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, 0))

    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        shape, kind, scale = spec
        if kind == "norm":
            return torch.rand(shape, generator=gen, device=device, dtype=dtype).mul_(0.5).add_(0.75)
        return torch.randn(shape, generator=gen, device=device, dtype=dtype).mul_(scale)

    return make(layout(m))

