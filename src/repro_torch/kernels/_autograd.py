"""The backward of the training kernels' autograd Functions: autograd of
the kernel's plain version, recomputed on the saved inputs.  The JAX
package defines no backward kernel (its training forward is jnp), so a
Function's gradients are the plain version's and only its forward is the
kernel's."""

from __future__ import annotations

import torch

__all__ = ["plain_backward"]


def plain_backward(plain, saved, needs, grad_out, **kw) -> list:
    """Gradients of ``plain(*saved, **kw)`` for the inputs whose ``needs``
    flag is set (None for the others and for a None input), recomputed
    under ``torch.enable_grad()``.  ``grad_out`` is one tensor for a plain
    version with one output, or a tuple with one entry per output, None
    where that output is not used."""
    inputs = [None if t is None else t.detach().requires_grad_(need)
              for t, need in zip(saved, needs)]
    wanted = [t for t in inputs if t is not None and t.requires_grad]
    with torch.enable_grad():
        outs = plain(*inputs, **kw)
        if isinstance(outs, torch.Tensor):
            outs, grad_out = (outs,), (grad_out,)
        used = [(o, g) for o, g in zip(outs, grad_out) if g is not None]
        grads = iter(torch.autograd.grad([o for o, _g in used], wanted,
                                         [g for _o, g in used], allow_unused=True))
    return [next(grads) if t is not None and t.requires_grad else None for t in inputs]
