"""AdamW on trees of tensors (the port of ``repro/training/optimizer.py``).

Plain functions, not ``torch.optim.AdamW`` (which applies the decay as a
separate step and rounds differently): the moments are kept in
``moment_dtype`` (float32 by default) and each leaf's update follows the
reference's order of operations -- float32 moments, ``delta = mhat /
(sqrt(vhat) + eps) + wd * p``, ``p - lr * delta`` and one cast back to the
parameter's dtype -- after clipping the gradients to ``grad_clip`` in
global norm.  :func:`adamw_update` writes the parameters and the moments
in place (the JAX package donates their buffers for the same effect) and
returns them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from ..tree import tree_leaves, tree_map

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update", "lr_schedule",
           "global_norm", "clip_by_global_norm"]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: Any = torch.float32
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor  # [] int32
    mu: Any  # first moment (tree)
    nu: Any  # second moment (tree)


def adamw_init(params: Any, cfg: AdamWConfig) -> OptState:
    """Zero moments beside each parameter; step 0 on the parameters' device."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None

    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)

    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def lr_schedule(step, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio``, in float32."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp_max(s / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((s - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree: Any) -> torch.Tensor:
    leaves = [torch.sum(torch.square(g.to(torch.float32))) for g in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(tree: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), tree), norm


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: OptState,
                 cfg: AdamWConfig) -> tuple[Any, OptState, dict]:
    """One AdamW step: ``(params, OptState(step + 1, mu, nu), {"lr",
    "grad_norm"})``, the parameters and moments updated in place."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(step, cfg)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)

    def upd(p, g, m, v):
        # The reference's expressions, each rounded in the same order,
        # computed in place with one scratch tensor (float32 moments are
        # updated where they lie): two allocations per leaf.
        g32, m32, v32, p32 = (t.to(torch.float32) for t in (g, m, v, p))
        tmp = torch.mul(g32, 1 - b1)
        m32.mul_(b1).add_(tmp)  # m * b1 + (1 - b1) * g
        torch.mul(g32, 1 - b2, out=tmp).mul_(g32)
        v32.mul_(b2).add_(tmp)  # v * b2 + (1 - b2) * g * g
        delta = torch.div(m32, bc1)  # mhat
        torch.div(v32, bc2, out=tmp).sqrt_().add_(cfg.eps)  # sqrt(vhat) + eps
        delta.div_(tmp).add_(torch.mul(p32, cfg.weight_decay, out=tmp)).mul_(lr)
        p32.sub_(delta)  # p - lr * delta
        for dst, src in ((p, p32), (m, m32), (v, v32)):
            if src is not dst:
                dst.copy_(src)
        return p

    tree_map(upd, params, grads, state.mu, state.nu)
    return params, OptState(step, state.mu, state.nu), {"lr": lr, "grad_norm": gnorm}
