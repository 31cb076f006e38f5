"""Dispatch: the CUDA kernel for CUDA tensors, the plain version for CPU."""

from __future__ import annotations

from . import kernel as _kernel, ref as _ref

__all__ = ["batch_decide"]


def batch_decide(lam, mu_eff, *, group, alpha, active, k_cur, k_max, k_hi: int,
                 j_cap: int | None = None):
    """``[B, N]`` solved rates -> ``(k4, k_start, t_cur, t4)``."""
    fn = _kernel.batch_decide if lam.is_cuda else _ref.batch_decide
    return fn(lam, mu_eff, group=group, alpha=alpha, active=active, k_cur=k_cur,
              k_max=k_max, k_hi=k_hi, j_cap=j_cap)
