"""Wrapper of the CUDA fused decide (``csrc/decide_fused.cu``), the Hopper
counterpart of ``repro/kernels/decide_fused/kernel.py:batch_decide_pallas``."""

from __future__ import annotations

import torch

from .. import _build

__all__ = ["batch_decide", "SMEM_LIMIT"]

#: Dynamic shared memory one block may use on the H100 (227 KB) less the
#: kernel's static reduction scratch.
SMEM_LIMIT = 232448 - 32 * 4
_MAX_THREADS = 1024


def batch_decide(lam, mu_eff, *, group, alpha, active, k_cur, k_max, k_hi: int,
                 j_cap: int | None = None):
    """``[B, N]`` float32 CUDA rates -> ``(k4 i32, k_start i32, t_cur f32,
    t4 f32)``.  ``group`` / ``active`` are bool, ``k_cur`` int32 [B, N],
    ``k_max`` int32 [B]."""
    if lam.ndim != 2:
        raise ValueError(f"lam must be [B, N], got shape {tuple(lam.shape)}")
    b, n = lam.shape
    dev = lam.device
    for name, t, dt in (("lam", lam, torch.float32), ("mu_eff", mu_eff, torch.float32),
                        ("alpha", alpha, torch.float32), ("group", group, torch.bool),
                        ("active", active, torch.bool), ("k_cur", k_cur, torch.int32)):
        _build.require(f"batch_decide {name}", t, dt, (b, n), device=dev)
    _build.require("batch_decide k_max", k_max, torch.int32, (b,), device=dev)
    if k_hi < 1:
        raise ValueError(f"k_hi must be >= 1, got {k_hi}")
    jc = k_hi if j_cap is None else max(min(int(j_cap), k_hi), 1)
    n_pad = max(32, -(-n // 32) * 32)
    if n_pad > _MAX_THREADS:
        raise ValueError(f"batch_decide: N={n} lanes exceed one block ({_MAX_THREADS})")
    lib = _build.library()
    smem = lib.repro_decide_fused_smem_bytes(n_pad, int(k_hi))
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"batch_decide: T/G tables need {smem} bytes of shared memory at "
            f"k_hi={k_hi}, N_pad={n_pad}; one H100 block holds {SMEM_LIMIT}"
        )
    k4 = torch.empty((b, n), dtype=torch.int32, device=dev)
    kst = torch.empty((b, n), dtype=torch.int32, device=dev)
    tcur = torch.empty((b, n), dtype=torch.float32, device=dev)
    t4 = torch.empty((b, n), dtype=torch.float32, device=dev)
    dev_idx, stream = _build.launch_args(lam)
    code = lib.repro_decide_fused(
        lam.data_ptr(), mu_eff.data_ptr(), group.data_ptr(), alpha.data_ptr(),
        active.data_ptr(), k_cur.data_ptr(), k_max.data_ptr(),
        k4.data_ptr(), kst.data_ptr(), tcur.data_ptr(), t4.data_ptr(),
        b, n, n_pad, int(k_hi), jc, dev_idx, stream,
    )
    _build.check_error("batch_decide", code)
    _build.count_launch("decide_fused")
    return k4, kst, tcur, t4
