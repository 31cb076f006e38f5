"""Batched analytic core -- vectorized Erlang/Jackson evaluation.

Two halves, as in ``repro/core/batched.py``:

* **numpy float64** (host spec code): :func:`sojourn_table` materialises
  ``E[T_i](k)`` for every operator and every ``k in [0, k_hi]`` in one
  Erlang-B pass, replaying the scalar recursion's float ops so finite
  entries equal ``erlang.expected_sojourn`` bit for bit; :func:`gain_table`
  turns it into Algorithm 1's marginal gains.  The allocator runs on these.
* **torch** (the control loop's device path): :func:`sojourn_table_torch`
  builds the same table from flat lanes, with its Erlang-B recursion
  dispatched to ``kernels/erlang_c`` (the CUDA kernel for CUDA tensors, the
  plain version for CPU ones), and :func:`solve_traffic_batch_torch` solves
  ``(I - P^T) lam = lam0`` per scenario.  The dtype follows the inputs.

:func:`expected_sojourn_batch` (E[T] of a ``[B, N]`` batch of allocations)
and :func:`solve_traffic_batch` take ``backend="torch"`` (the default: the
torch half on ``device``, the CUDA device unless told otherwise, in
``dtype``, float32 unless told otherwise) or ``backend="numpy"`` (the
float64 host twin, the reference's default).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .jackson import Topology

__all__ = [
    "OperatorArrays",
    "operator_arrays",
    "sojourn_table",
    "gain_table",
    "sojourn_from_table",
    "expected_sojourn_batch",
    "solve_traffic_batch",
    "sojourn_table_torch",
    "expected_sojourn_batch_torch",
    "solve_traffic_batch_torch",
]

BACKENDS = ("torch", "numpy")


@dataclass(frozen=True)
class OperatorArrays:
    """Flat per-operator arrays (index order matches the Topology's)."""

    lam: np.ndarray  # solved per-operator arrival rates [N]
    mu: np.ndarray  # per-processor service rates [N]
    group: np.ndarray  # bool [N]: True = chip-gang scaling (M/M/1 @ mu*k*eff)
    alpha: np.ndarray  # group efficiency rolloff [N]
    min_k: np.ndarray  # per-operator floor [N]
    lam0_total: float


def operator_arrays(top: Topology) -> OperatorArrays:
    ops = top.operators
    return OperatorArrays(
        lam=np.asarray(top.arrival_rates, dtype=np.float64),
        mu=np.array([op.mu for op in ops], dtype=np.float64),
        group=np.array([op.scaling == "group" for op in ops], dtype=bool),
        alpha=np.array([op.group_alpha for op in ops], dtype=np.float64),
        min_k=np.array([op.min_k for op in ops], dtype=np.int64),
        lam0_total=top.lam0_total,
    )


# --------------------------------------------------------------------------- #
# numpy float64 half (bit-compatible with the scalar core)
# --------------------------------------------------------------------------- #
def sojourn_table(top: Topology, k_hi: int) -> np.ndarray:
    """``T[i, k] = E[T_i](k)`` for ``k in [0, k_hi]`` -- ``[N, k_hi+1]``.

    Entries below ``min_k`` or in the unstable region are ``+inf``; finite
    entries are bit-identical to the scalar ``OperatorSpec.sojourn``.
    """
    if k_hi < 0:
        raise ValueError(f"k_hi must be >= 0, got {k_hi}")
    arr = operator_arrays(top)
    n = arr.lam.shape[0]
    T = np.full((n, k_hi + 1), np.inf, dtype=np.float64)

    rep = ~arr.group
    if rep.any():
        lam, mu = arr.lam[rep], arr.mu[rep]
        a = lam / mu
        r = int(rep.sum())
        # The recursion is sequential in j; narrow operator sets run it in
        # plain Python floats (the same float ops as erlang.erlang_b).
        B = np.empty((r, k_hi + 1), dtype=np.float64)
        B[:, 0] = 1.0
        if r <= 64:
            for i in range(r):
                ai = float(a[i])
                row = B[i]
                b = 1.0
                for j in range(1, k_hi + 1):
                    ab = ai * b
                    b = ab / (j + ab)
                    row[j] = b
        else:
            b = np.ones_like(a)
            for j in range(1, k_hi + 1):
                ab = a * b
                b = ab / (j + ab)
                B[:, j] = b
        ks = np.arange(k_hi + 1, dtype=np.int64)[None, :]
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            c = ks * B / (ks - a[:, None] * (1.0 - B))
            t = c / (ks * mu[:, None] - lam[:, None]) + 1.0 / mu[:, None]
            sub = np.where(ks > a[:, None], t, np.inf)
        T[rep] = sub

    if arr.group.any():
        ks = np.arange(k_hi + 1, dtype=np.float64)
        for i in np.nonzero(arr.group)[0]:
            lam, mu, alpha = arr.lam[i], arr.mu[i], arr.alpha[i]
            with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
                eff = 1.0 / (1.0 + alpha * (ks - 1.0))
                mu_eff = mu * ks * eff
                a = lam / mu_eff
                stable = 1.0 > a
                b = a / (1.0 + a)  # the j=1 step of the B recursion
                c = b / (1.0 - a * (1.0 - b))
                t = c / (mu_eff - lam) + 1.0 / mu_eff
            row = np.full(k_hi + 1, np.inf)
            row[stable] = t[stable]
            T[i] = row

    for i in range(n):
        lo = min(int(arr.min_k[i]), k_hi + 1)
        T[i, :lo] = np.inf
    return T


def gain_table(top: Topology, k_hi: int) -> tuple[np.ndarray, np.ndarray]:
    """``(T, G)`` with ``G[i, k] = lam_i * (T[i,k] - T[i,k+1])`` (``[N,
    k_hi]``, ``+inf`` where ``T[i, k]`` is infinite)."""
    T = sojourn_table(top, k_hi)
    lam = np.asarray(top.arrival_rates, dtype=np.float64)
    with np.errstate(invalid="ignore"):
        G = lam[:, None] * (T[:, :-1] - T[:, 1:])
    G[np.isinf(T[:, :-1])] = np.inf
    return T, G


def sojourn_from_table(T: np.ndarray, k: np.ndarray, lam: np.ndarray, lam0_total: float):
    """Per-op sojourns and E[T] (paper Eq. 3) gathered from the table.
    ``k`` is ``[N]`` or ``[B, N]``; returns ``(per_op, e2e)`` with the
    matching leading shape (a vectorized sum: ~1e-12 of the scalar
    sequential sum)."""
    k = np.asarray(k, dtype=np.int64)
    per_op = np.take_along_axis(
        np.broadcast_to(T, k.shape[:-1] + T.shape), k[..., None], axis=-1
    )[..., 0]
    with np.errstate(invalid="ignore"):  # 0 * inf on zero-traffic operators
        contrib = np.where(lam > 0, lam * per_op, 0.0)
    e2e = contrib.sum(axis=-1) / max(lam0_total, 1e-300)  # idle-network guard
    return per_op, e2e


def _backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")


def expected_sojourn_batch(top: Topology, k_batch, *, backend: str = "torch",
                           device=None, dtype=None) -> np.ndarray:
    """E[T](k) for a ``[B, N]`` batch of allocations, as ``[B]`` float64.

    ``backend="torch"``: :func:`expected_sojourn_batch_torch` on ``device``
    (default: the CUDA device, one ``erlang_c`` launch) in ``dtype``
    (default float32).  ``backend="numpy"``: the float64 table and gather.
    """
    _backend(backend)
    k_batch = np.atleast_2d(np.asarray(k_batch, dtype=np.int64))
    if k_batch.shape[-1] != top.n:
        raise ValueError(f"k batch must be [B, {top.n}], got {k_batch.shape}")
    if backend == "torch":
        from ..device import resolve_device

        dev = resolve_device(device)
        e2e = expected_sojourn_batch_torch(
            top, torch.as_tensor(k_batch, device=dev),
            dtype=torch.float32 if dtype is None else dtype)
        return e2e.cpu().numpy().astype(np.float64)
    k_hi = int(k_batch.max(initial=0))
    T = sojourn_table(top, k_hi)
    _, e2e = sojourn_from_table(T, k_batch, top.arrival_rates, top.lam0_total)
    return e2e


def solve_traffic_batch(lam0_batch, routing, *, backend: str = "torch", device=None,
                        dtype=None) -> np.ndarray:
    """Traffic equations ``lam = lam0 + P^T lam`` for ``[B, N]`` externals
    and one shared ``[N, N]`` or per-scenario ``[B, N, N]`` routing, as
    ``[B, N]`` float64 (magnitudes below 1e-12 snap to 0).
    ``backend="torch"`` runs :func:`solve_traffic_batch_torch` on ``device``
    (default: the CUDA device) in ``dtype`` (default float32);
    ``backend="numpy"`` the float64 ``np.linalg.solve``."""
    _backend(backend)
    lam0 = np.atleast_2d(np.asarray(lam0_batch, dtype=np.float64))
    p = np.asarray(routing, dtype=np.float64)
    n = lam0.shape[-1]
    if p.shape not in ((n, n),) and p.shape != (lam0.shape[0], n, n):
        raise ValueError(
            f"routing must be ({n},{n}) or ({lam0.shape[0]},{n},{n}), got {p.shape}"
        )
    if backend == "torch":
        from ..device import resolve_device

        dev = resolve_device(device)
        dtype = torch.float32 if dtype is None else dtype
        lam = solve_traffic_batch_torch(torch.as_tensor(lam0, dtype=dtype, device=dev),
                                        torch.as_tensor(p, dtype=dtype, device=dev))
        return lam.cpu().numpy().astype(np.float64)
    pt = np.swapaxes(p, -1, -2)
    a = np.eye(n) - pt
    lam = np.linalg.solve(a, lam0[..., None])[..., 0] if a.ndim == 3 else (
        np.linalg.solve(a, lam0.T).T
    )
    lam[np.abs(lam) < 1e-12] = 0.0
    return lam


# --------------------------------------------------------------------------- #
# torch half -- the control loop's device path
# --------------------------------------------------------------------------- #
def sojourn_table_torch(lam, mu, *, k_hi: int, group=None, alpha=None, min_k=None,
                        plain: bool = False):
    """``[S, k_hi+1]`` sojourn table over ``S`` flat operator lanes.

    Replica lanes use the Erlang-B table (``kernels/erlang_c``: the CUDA
    kernel for CUDA tensors; ``plain=True`` forces the plain version, as the
    fused decide's plain version needs) and the Erlang-C conversion; group
    lanes the M/M/1 closed form at ``mu * k * eff(k)``.  Columns below each
    lane's ``min_k`` are ``+inf``.
    """
    from ..kernels.erlang_c import ops as erlang_ops, ref as erlang_ref

    dtype, dev = lam.dtype, lam.device
    mu = mu.to(dtype)
    n = lam.shape[0]
    group = (torch.zeros(n, dtype=torch.bool, device=dev) if group is None
             else group.to(torch.bool))
    alpha = torch.zeros(n, dtype=dtype, device=dev) if alpha is None else alpha.to(dtype)
    min_k = (torch.ones(n, dtype=torch.int32, device=dev) if min_k is None
             else min_k.to(torch.int32))
    kk = torch.arange(k_hi + 1, dtype=dtype, device=dev)[None, :]
    inf = float("inf")

    a_rep = lam / mu
    erlang = erlang_ref.erlang_b_table if plain else erlang_ops.erlang_b_table
    btab = erlang(a_rep, k_hi=k_hi).T.to(dtype)  # [S, K+1]
    c = kk * btab / (kk - a_rep[:, None] * (1.0 - btab))
    t_rep = c / (kk * mu[:, None] - lam[:, None]) + 1.0 / mu[:, None]
    t_rep = torch.where(kk > a_rep[:, None], t_rep, inf)

    eff = 1.0 / (1.0 + alpha[:, None] * (kk - 1.0))
    mu_eff = mu[:, None] * kk * eff
    a_grp = lam[:, None] / mu_eff
    b = a_grp / (1.0 + a_grp)
    cg = b / (1.0 - a_grp * (1.0 - b))
    t_grp = cg / (mu_eff - lam[:, None]) + 1.0 / mu_eff
    t_grp = torch.where(a_grp < 1.0, t_grp, inf)

    T = torch.where(group[:, None], t_grp, t_rep)
    return torch.where(kk >= min_k[:, None], T, inf)


def expected_sojourn_batch_torch(top: Topology, k_batch, *, dtype=None):
    """E[T](k) over a ``[B, N]`` integer tensor of allocations, as a ``[B]``
    tensor on ``k_batch``'s device: the :func:`sojourn_table_torch` table
    (one ``erlang_c`` launch on a card) up to the batch's largest ``k``,
    gathered per operator.  ``dtype`` defaults to float32."""
    dtype = torch.float32 if dtype is None else dtype
    arr = operator_arrays(top)
    dev = k_batch.device
    k_batch = torch.atleast_2d(k_batch).to(torch.int64)
    k_hi = int(k_batch.max()) if k_batch.numel() else 0

    def t(x, dt=dtype):
        return torch.as_tensor(x, dtype=dt, device=dev)

    T = sojourn_table_torch(t(arr.lam), t(arr.mu), k_hi=max(k_hi, 0),
                            group=t(arr.group, torch.bool), alpha=t(arr.alpha),
                            min_k=t(arr.min_k, torch.int32))
    per_op = torch.gather(T.expand(k_batch.shape[0], *T.shape), 2, k_batch[..., None])[..., 0]
    lam = t(arr.lam)
    contrib = torch.where(lam > 0, lam * per_op, 0.0)
    return contrib.sum(dim=-1) / max(arr.lam0_total, 1e-300)


def solve_traffic_batch_torch(lam0_batch, routing):
    """Per-scenario traffic solve ``(I - P^T) lam = lam0`` for ``[B, N]``
    externals and ``[B, N, N]`` routing; tiny magnitudes (< 1e-12) snap to 0.

    ``torch.linalg.solve_ex`` reports a singular system through its info
    output instead of raising, so a bad lane yields non-finite rates that
    the decide masks -- the same contract as ``jnp.linalg.solve``.
    """
    lam0 = lam0_batch
    p = routing.to(lam0.dtype)
    n = lam0.shape[-1]
    eye = torch.eye(n, dtype=lam0.dtype, device=lam0.device)
    a = eye - p.transpose(-1, -2)
    lam = torch.linalg.solve_ex(a, lam0[..., None])[0][..., 0]
    return torch.where(torch.abs(lam) < 1e-12, 0.0, lam)
