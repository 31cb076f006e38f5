"""Plain PyTorch version of the SwiGLU kernel: the same math as
``repro/kernels/swiglu/ref.py``, op for op.

    out = (silu(x Wg) * (x Wu)) Wo,  x [T, D], Wg / Wu [D, F], Wo [F, D]

The gate and up products come out in x's dtype (so in bf16 they round
before the float32 silu and multiply), the hidden is cast to x's dtype
before the Wo product.  The CUDA kernel follows the TPU kernel instead
(``repro/kernels/swiglu/kernel.py:37``): gate and up stay float32 and the
hidden rounds once; in float32 the two agree to rounding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["swiglu"]


def swiglu(x, wg, wu, wo) -> torch.Tensor:
    h = F.silu((x @ wg).to(torch.float32)) * (x @ wu).to(torch.float32)
    return (h.to(x.dtype) @ wo).to(x.dtype)
