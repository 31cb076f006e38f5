"""Feed-forward layers (the port of ``repro/models/ffn.py``): SwiGLU.

``swiglu`` runs through ``kernels/swiglu``, so it has that kernel's
numerics: on the card the TPU kernel's (gate and up products in float32,
the hidden rounded once), on the CPU the kernel reference's (gate and up
rounded to the activation dtype first).  The reference model's own
``ffn.swiglu`` rounds ``silu(gate)`` and the product separately; in bf16
the three differ by bf16 rounding, in float32 they agree (ROADMAP Queue 3).
MoE waits (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import torch

from ..kernels.swiglu import ops as swiglu_ops

__all__ = ["swiglu"]


def swiglu(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x [.., D] with params wi_gate [D, F], wi_up [D, F], wo [F, D]."""
    lead = x.shape[:-1]
    out = swiglu_ops.swiglu(x.reshape(-1, x.shape[-1]), params["wi_gate"], params["wi_up"],
                            params["wo"])
    return out.reshape(*lead, out.shape[-1])
