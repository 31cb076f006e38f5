"""The backward of the training kernels' autograd Functions: autograd of
the kernel's plain version, recomputed on the saved inputs.  The JAX
package defines no backward kernel (its training forward is jnp), so a
Function's gradients are the plain version's and only its forward is the
kernel's."""

from __future__ import annotations

import torch

__all__ = ["plain_backward"]


def plain_backward(plain, saved, needs, grad_out, **kw) -> list:
    """Gradients of ``plain(*saved, **kw)`` against ``grad_out`` for the
    inputs whose ``needs`` flag is set (None for the others), recomputed
    under ``torch.enable_grad()``."""
    inputs = [t.detach().requires_grad_(need) for t, need in zip(saved, needs)]
    wanted = [t for t in inputs if t.requires_grad]
    with torch.enable_grad():
        grads = iter(torch.autograd.grad(plain(*inputs, **kw), wanted, grad_out))
    return [next(grads) if t.requires_grad else None for t in inputs]
