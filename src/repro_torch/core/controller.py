"""Batched closed-loop controller -- simulate -> measure -> decide -> apply
over ``[B, N]`` tensors (the PyTorch counterpart of
``repro/core/controller.py``'s jit path).

* :func:`make_decide` builds the whole non-negotiated decide over a
  scenario fleet: overload trigger and capped propagation, offered-load
  clamping, the batched Jackson solve, Program 4 either two-pass (sojourn
  table through ``kernels/erlang_c`` -> gains -> ``kernels/gain_topr``) or
  in one pass (``kernels/decide_fused``), and the improvement and cost
  gates.  Both dispatches share the pricing tail, so their decisions agree
  bit for bit.
* :func:`make_fused_loop` returns a :class:`FusedLoop` that advances the
  fleet one control window per tick: the batch simulator's window
  (``kernels/queue_step``'s window kernel), the window measurement, the
  decide and the apply.  The JAX package's ``lax.scan`` over ticks is a Python loop
  here; the loop state is a :class:`ControllerState` of tensors.
* :func:`decide_single` is the float64 numpy twin of one scenario's
  decide, which the live :class:`~repro_torch.core.scheduler.DRSScheduler`
  calls each tick (with :func:`overloaded_mask_batch`,
  :func:`capped_mask_batch` and :func:`clamp_row` for the measured model):
  the reference's branch order and float ops, so its actions, allocations
  and E[T] equal the JAX package's bit for bit.
* :func:`tick_batch` is the batched float64 twin the window-at-a-time
  :class:`~repro_torch.api.session.ScenarioRunner` runs: the overload
  trigger, the capped propagation and snapshot completeness vectorised,
  then :func:`clamp_row` and :func:`decide_single` per scenario, with the
  negotiators' lease hooks.
* ``proactive=`` (the forecast/MPC plane of :mod:`repro_torch.forecast`)
  and ``compact=`` / ``compact_state=`` (the sparse decide: lanes whose
  decide inputs are bitwise unchanged replay their cached outputs, the
  rest are priced at the smallest rung of a static width ladder that holds
  them) run in the fused loop, the standalone decide and the twin, with
  the reference's outputs: compaction changes where the work runs, never
  a result.

Entry points run on the CUDA device unless ``device`` says otherwise; there
the kernels run in float32.  On the CPU every kernel call takes its plain
PyTorch version, in float32 or float64.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, replace
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..device import resolve_device
from .allocator import (
    AllocationResult,
    InsufficientResourcesError,
    assign_processors,
    assign_processors_table,
    min_processors,
    min_processors_table,
)
from .jackson import OperatorSpec, Topology, UnstableTopologyError
from .rebalance import RebalanceCostModel, RebalancePlan

__all__ = [
    "ACTIONS",
    "ALLOCATORS",
    "DROP_TRIGGER_FRACTION",
    "PAUSE_SECONDS",
    "ControllerStatic",
    "ControllerParams",
    "ControllerState",
    "CompactionConfig",
    "DecideCache",
    "TwinCompactionState",
    "init_decide_cache",
    "pad_static",
    "pad_params",
    "FusedLoop",
    "init_state",
    "make_decide",
    "make_fused_loop",
    "RowDecision",
    "BatchDecision",
    "tick_batch",
    "effective_capacity",
    "overloaded_mask_batch",
    "capped_mask_batch",
    "clamp_row",
    "decide_single",
]

# Action vocabulary; codes match repro.core.controller.ACTIONS.
ACTIONS = (
    "none",
    "rebalance",
    "scale_out",
    "scale_in",
    "infeasible",
    "overloaded",
    "rebalance_hint",
    "proactive",
)
_CODE = {name: i for i, name in enumerate(ACTIONS)}

# An operator shedding more than this fraction of its capacity is
# overloaded even if its smoothed arrival rate sits below capacity.
DROP_TRIGGER_FRACTION = 0.01

# Control-plane pause charged by the cost gate: the value of
# repro.core.rebalance.RebalanceCostModel().pause_cache_miss (5.0 s).
PAUSE_SECONDS = 5.0


@dataclass(frozen=True)
class ControllerStatic:
    """Declared per-scenario structure, padded to the batch-wide N_max
    (lanes beyond ``n_ops[b]`` are inert: no routing, ``active`` False)."""

    base_routing: np.ndarray  # [B, N, N] declared multiplicities
    group: np.ndarray  # [B, N] bool: chip-gang scaling
    alpha: np.ndarray  # [B, N] group efficiency rolloff
    active: np.ndarray  # [B, N] bool: real operator lanes
    speed: np.ndarray  # [B, N] machine-class speed factors
    n_ops: np.ndarray  # [B] operators per scenario
    names: tuple  # per-scenario tuple of operator names

    @property
    def batch(self) -> int:
        return self.base_routing.shape[0]

    @property
    def n(self) -> int:
        return self.base_routing.shape[1]

    @classmethod
    def from_graphs(cls, graphs: Sequence, *, speed=None) -> "ControllerStatic":
        """Stack B AppGraphs (padded) into one static bundle."""
        b = len(graphs)
        n = max(g.n for g in graphs)
        routing = np.zeros((b, n, n))
        group = np.zeros((b, n), dtype=bool)
        alpha = np.zeros((b, n))
        active = np.zeros((b, n), dtype=bool)
        spd = np.ones((b, n))
        n_ops = np.zeros(b, dtype=np.int64)
        names = []
        for bi, g in enumerate(graphs):
            ni = g.n
            routing[bi, :ni, :ni] = g.routing_matrix()
            scaling, ga = g.scaling_lists()
            group[bi, :ni] = [s == "group" for s in scaling]
            alpha[bi, :ni] = ga
            active[bi, :ni] = True
            n_ops[bi] = ni
            names.append(tuple(g.names))
            if speed is not None and speed[bi] is not None:
                spd[bi, :ni] = speed[bi]
        return cls(routing, group, alpha, active, spd, n_ops, tuple(names))


@dataclass(frozen=True)
class ControllerParams:
    """Per-scenario decision parameters (``SchedulerConfig``, stacked).
    ``t_max`` is NaN for "no real-time constraint"."""

    t_max: np.ndarray  # [B] float
    k_max: np.ndarray  # [B] int64 budget
    headroom: np.ndarray  # [B]
    scale_in_hysteresis: np.ndarray  # [B]
    min_improvement: np.ndarray  # [B]
    horizon_seconds: np.ndarray  # [B]
    allocator: tuple  # [B] "table" | "heap"
    fused_decide: bool = False  # dispatch the decide to kernels/decide_fused

    @classmethod
    def stack(cls, configs: Sequence, k_max: Sequence[int]) -> "ControllerParams":
        """From B SchedulerConfig-likes + per-scenario budgets."""
        per_lane = [bool(getattr(c, "fused_decide", False)) for c in configs]
        flags = set(per_lane)
        if len(flags) > 1:
            on = [i for i, f in enumerate(per_lane) if f]
            off = [i for i, f in enumerate(per_lane) if not f]
            raise ValueError(
                "fused_decide must agree across a stacked batch (one decide "
                f"serves every scenario lane); scenario indices {on} set "
                f"fused_decide=True while {off} leave it False"
            )
        return cls(
            t_max=np.array([np.nan if c.t_max is None else float(c.t_max) for c in configs]),
            k_max=np.asarray(k_max, dtype=np.int64),
            headroom=np.array([c.headroom for c in configs]),
            scale_in_hysteresis=np.array([c.scale_in_hysteresis for c in configs]),
            min_improvement=np.array([c.min_improvement for c in configs]),
            horizon_seconds=np.array([c.horizon_seconds for c in configs]),
            allocator=tuple(c.allocator for c in configs),
            fused_decide=flags.pop() if flags else False,
        )


# --------------------------------------------------------------------------- #
# Batch-axis padding (a fleet mesh needs B % rank count == 0)
# --------------------------------------------------------------------------- #
def pad_static(static: ControllerStatic, b_total: int) -> ControllerStatic:
    """Append ``b_total - B`` inert scenario lanes: no operators
    (``n_ops = 0``), ``active`` all False, zero routing and alpha, unit
    speed.  A padded lane decides ``"none"`` with its allocation unchanged,
    in the decide and in the twin, so it never moves a real lane."""
    b, n = static.batch, static.n
    if b_total < b:
        raise ValueError(f"b_total {b_total} < batch {b}")
    if b_total == b:
        return static
    pad = b_total - b
    return ControllerStatic(
        base_routing=np.concatenate([static.base_routing, np.zeros((pad, n, n))], axis=0),
        group=np.concatenate([static.group, np.zeros((pad, n), dtype=bool)]),
        alpha=np.concatenate([static.alpha, np.zeros((pad, n))]),
        active=np.concatenate([static.active, np.zeros((pad, n), dtype=bool)]),
        speed=np.concatenate([static.speed, np.ones((pad, n))]),
        n_ops=np.concatenate([static.n_ops, np.zeros(pad, dtype=np.int64)]),
        names=static.names + ((),) * pad,
    )


def pad_params(params: ControllerParams, b_total: int) -> ControllerParams:
    """Decision parameters of inert padded lanes: no constraint (``t_max =
    NaN``), zero budget and an infinite improvement gate, so every gate of
    the decide stays closed on them."""
    b = params.k_max.shape[0]
    if b_total < b:
        raise ValueError(f"b_total {b_total} < batch {b}")
    if b_total == b:
        return params
    pad = b_total - b
    return ControllerParams(
        t_max=np.concatenate([params.t_max, np.full(pad, np.nan)]),
        k_max=np.concatenate([params.k_max, np.zeros(pad, dtype=np.int64)]),
        headroom=np.concatenate([params.headroom, np.ones(pad)]),
        scale_in_hysteresis=np.concatenate([params.scale_in_hysteresis, np.zeros(pad)]),
        min_improvement=np.concatenate([params.min_improvement, np.full(pad, np.inf)]),
        horizon_seconds=np.concatenate([params.horizon_seconds, np.zeros(pad)]),
        allocator=params.allocator + ("table",) * pad,
        fused_decide=params.fused_decide,
    )


def _mesh_axis(mesh) -> tuple[str, int]:
    """The (axis name, rank count) of a 1-D fleet mesh; anything else is
    refused."""
    from ..distributed.sharding import mesh_axis

    return mesh_axis(mesh, "controller")


def _padded_batch(b: int, n_shards: int) -> int:
    """B rounded up to a multiple of the shard count."""
    return -(-b // n_shards) * n_shards


def _lanes(x, sl: slice):
    """Rows ``sl`` of every ``[B, ...]`` leaf of a tensor tree (tuples,
    NamedTuples, dicts), as contiguous copies."""
    if isinstance(x, torch.Tensor):
        return x[sl].clone()
    if isinstance(x, dict):
        return {k: _lanes(v, sl) for k, v in x.items()}
    if isinstance(x, tuple):
        vals = [_lanes(v, sl) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x


def _source_mask(static: ControllerStatic) -> np.ndarray:
    """[B, N] bool: declared entry points (no in-edges; a scenario with none
    falls back to operator 0)."""
    in_deg = static.base_routing.sum(axis=1)
    src = (in_deg == 0) & static.active
    for bi in range(static.batch):
        if not src[bi].any():
            src[bi, 0] = True
    return src


def _decide_statics(static: ControllerStatic, params: ControllerParams, *, device,
                    dtype) -> dict:
    """The decide's per-lane inputs as one dict of ``[B, ...]`` tensors."""
    def f(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype, device=device)

    def bool_(x):
        return torch.as_tensor(np.asarray(x, dtype=bool), device=device)

    return {
        "routing0": f(static.base_routing),
        "group": bool_(static.group),
        "alpha": f(static.alpha),
        "active": bool_(static.active),
        "speed": f(static.speed),
        "src": bool_(_source_mask(static)),
        "k_max": torch.as_tensor(np.asarray(params.k_max), dtype=torch.int32, device=device),
        "min_improvement": f(params.min_improvement),
        "horizon": f(params.horizon_seconds),
    }


def _overloaded(lam_hat, mu_eff, drop_hat, k_cur, group, alpha, active):
    """[B, N] bool: the overload trigger on tensors -- measured offered load
    at capacity (k floored at 1) or shedding more than
    ``DROP_TRIGGER_FRACTION`` of it, on active lanes with finite rates."""
    k_floor = torch.clamp_min(k_cur, 1).to(lam_hat.dtype)
    eff = 1.0 / (1.0 + alpha * (k_floor - 1.0))
    capacity = torch.where(group, mu_eff * k_floor * eff, mu_eff * k_floor)
    valid = torch.isfinite(lam_hat) & torch.isfinite(mu_eff) & (mu_eff > 0)
    drops = torch.nan_to_num(drop_hat, nan=0.0)
    return valid & active & (
        (lam_hat >= capacity * (1.0 - 1e-9))
        | (drops > DROP_TRIGGER_FRACTION * capacity)
    )


# --------------------------------------------------------------------------- #
# Trigger-gated lane compaction (the sparse decide)
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class CompactionConfig:
    """Knobs of the sparse decide.  ``b_active_cap`` is the ascending ladder
    of compacted widths (the batch extent is always added as the dense
    rung); ``None`` takes :func:`repro_torch.distributed.bucket_ladder`.

    The compaction is exact: the decide is a pure function of ``(statics,
    lam_hat, mu_hat, drop_hat, lam0_hat, k)``, so a lane whose inputs are
    bitwise unchanged since it was last priced (NaN equal to NaN) replays
    its cached outputs, which are what repricing would give.  A lane is
    repriced when it has no cached entry, when an input changed, or when
    the overload trigger fires on it."""

    b_active_cap: tuple[int, ...] | None = None


class DecideCache(NamedTuple):
    """Per-lane memo of the sparse decide: the inputs each lane was last
    priced with and the outputs it got.  Not part of
    :class:`ControllerState`: a cold cache only makes the next tick price
    every lane (the same outputs, more work)."""

    ok: Any  # [B] bool: the lane has a priced entry
    lam: Any  # [B, N]
    mu: Any  # [B, N]
    drop: Any  # [B, N]
    lam0: Any  # [B]
    k: Any  # [B, N] int32 allocation at entry
    code: Any  # [B] int32
    k_next: Any  # [B, N] int32
    et_cur: Any  # [B]
    et_target: Any  # [B]
    applied: Any  # [B] bool


def init_decide_cache(b: int, n: int, *, dtype, device) -> DecideCache:
    """A cold cache: the first tick prices every lane."""
    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return DecideCache(ok=z(b, dt=torch.bool), lam=z(b, n), mu=z(b, n), drop=z(b, n),
                       lam0=z(b), k=z(b, n, dt=torch.int32), code=z(b, dt=torch.int32),
                       k_next=z(b, n, dt=torch.int32), et_cur=z(b), et_target=z(b),
                       applied=z(b, dt=torch.bool))


def _resolve_ladder(compact, b: int) -> tuple[int, ...]:
    """The ladder of compacted widths for a batch extent ``b``."""
    from ..distributed.sharding import bucket_ladder

    cfg = compact if isinstance(compact, CompactionConfig) else CompactionConfig()
    if cfg.b_active_cap is None:
        return bucket_ladder(b)
    ladder = tuple(sorted({min(int(w), b) for w in cfg.b_active_cap} | {b}))
    if ladder[0] < 1:
        raise ValueError(f"bucket ladder widths must be >= 1: {cfg.b_active_cap}")
    return ladder


def _bucketed(ladder, b: int, mask, count: int, run_at_width, templates):
    """Gather -> compute -> scatter over the ``count`` lanes of ``mask [B]``
    at the smallest ladder width that holds them; the other lanes keep
    their ``templates`` values.  ``count`` is ``mask``'s count as a host
    int (the caller's one device-to-host read), so no rung runs when it is
    0 and the scatter needs no sync.  ``run_at_width(idx)`` gets ``[w]``
    lane indices: the masked lanes in order, then the clipped index ``b -
    1`` in the tail rows, which compute garbage that is never scattered
    (every op of the decide and the planner is per lane)."""
    if count == 0:
        return tuple(templates)
    w = next(x for x in ladder if x >= count)
    # A stable sort puts the masked lanes first, in index order.
    order = torch.argsort((~mask).to(torch.uint8), stable=True)
    idx = order[:w].clone()
    idx[count:] = b - 1
    outs = run_at_width(idx)
    real = idx[:count]
    return tuple(t.index_copy(0, real, o[:count]) for t, o in zip(templates, outs))


def _neq(a, c):
    """The bitwise change test, NaN equal to NaN (a persistently NaN
    measurement must not keep a lane hot)."""
    return (a != c) & ~(torch.isnan(a) & torch.isnan(c))


def _make_compact_decide(core, b: int, ladder: tuple[int, ...]):
    """The dense decide ``core`` behind the trigger scan and the bucketed
    dispatch: ``decide(st, lam_hat, mu_hat, drop_hat, lam0_hat, k_current,
    cache) -> ((code, k_next, et_cur, et_target, applied), repriced [B],
    cache')``, equal to ``core(...)`` on every output.

    ``decide.scan(...)`` is the O(B N) trigger scan alone; a caller that
    has already run it (and read its count) passes ``repriced=`` and
    ``count=``, else the decide reads the count itself, one device-to-host
    copy per call."""

    def scan(st, lam_hat, mu_hat, drop_hat, lam0_hat, k_in, cache):
        mu_eff = mu_hat * st["speed"]
        hot = _overloaded(lam_hat, mu_eff, drop_hat, k_in, st["group"], st["alpha"],
                          st["active"]).any(dim=-1)
        changed = (
            _neq(lam_hat, cache.lam).any(dim=-1)
            | _neq(mu_hat, cache.mu).any(dim=-1)
            | _neq(drop_hat, cache.drop).any(dim=-1)
            | _neq(lam0_hat, cache.lam0)
            | (k_in != cache.k).any(dim=-1)
        )
        return ~cache.ok | changed | hot

    def decide(st, lam_hat, mu_hat, drop_hat, lam0_hat, k_current, cache, *,
               repriced=None, count: int | None = None):
        k_in = k_current.to(torch.int32)
        if repriced is None:
            repriced = scan(st, lam_hat, mu_hat, drop_hat, lam0_hat, k_in, cache)
        if count is None:
            count = int(repriced.sum())

        def price(g):
            st_g = {key: val[g] for key, val in st.items()}
            return core(st_g, lam_hat[g], mu_hat[g], drop_hat[g], lam0_hat[g], k_in[g])

        code, k_next, et_cur, et_target, applied = _bucketed(
            ladder, b, repriced, count, price,
            (cache.code, cache.k_next, cache.et_cur, cache.et_target, cache.applied),
        )
        new_cache = DecideCache(
            ok=torch.ones_like(cache.ok), lam=lam_hat, mu=mu_hat, drop=drop_hat,
            lam0=lam0_hat, k=k_in, code=code, k_next=k_next, et_cur=et_cur,
            et_target=et_target, applied=applied,
        )
        return (code, k_next, et_cur, et_target, applied), repriced, new_cache

    decide.scan = scan
    return decide


@dataclass
class TwinCompactionState:
    """Per-lane memo of the float64 twin's reactive decide (mutable,
    caller-owned: pass it to every :func:`tick_batch` of one run).  Lanes
    with a negotiator ``ensure`` hook or a custom cost model are never
    memoized; for the rest a bitwise-unchanged input tuple replays the
    cached :class:`RowDecision`.  Valid for one ``(static, params)`` but
    ``k_max``, which is compared per tick (leases move it)."""

    valid: np.ndarray  # [B] bool
    lam: np.ndarray  # [B, N]
    mu: np.ndarray  # [B, N]
    drop: np.ndarray  # [B, N]
    lam0: np.ndarray  # [B]
    k: np.ndarray  # [B, N] int64
    k_max: np.ndarray  # [B] int64
    rows: list  # [B] RowDecision | None
    errors: list  # [B] Exception | None
    replayed: np.ndarray  # [B] bool: the last tick's replayed lanes

    @classmethod
    def create(cls, b: int, n: int) -> "TwinCompactionState":
        return cls(
            valid=np.zeros(b, dtype=bool),
            lam=np.full((b, n), np.nan),
            mu=np.full((b, n), np.nan),
            drop=np.full((b, n), np.nan),
            lam0=np.full(b, np.nan),
            k=np.zeros((b, n), dtype=np.int64),
            k_max=np.zeros(b, dtype=np.int64),
            rows=[None] * b,
            errors=[None] * b,
            replayed=np.zeros(b, dtype=bool),
        )

    def hit(self, bi, lam, mu, drop, lam0, k, k_max) -> bool:
        return bool(
            self.valid[bi]
            and self.k_max[bi] == k_max
            and np.array_equal(self.k[bi, : len(k)], k)
            and np.array_equal(self.lam[bi, : len(lam)], lam, equal_nan=True)
            and np.array_equal(self.mu[bi, : len(mu)], mu, equal_nan=True)
            and np.array_equal(self.drop[bi, : len(drop)], drop, equal_nan=True)
            and (
                np.isnan(self.lam0[bi]) and np.isnan(lam0)
                or self.lam0[bi] == lam0
            )
        )

    def remember(self, bi, lam, mu, drop, lam0, k, k_max, row, error) -> None:
        self.valid[bi] = True
        self.lam[bi, : len(lam)] = lam
        self.mu[bi, : len(mu)] = mu
        self.drop[bi, : len(drop)] = drop
        self.lam0[bi] = lam0
        self.k[bi, : len(k)] = k
        self.k_max[bi] = k_max
        self.rows[bi] = row
        self.errors[bi] = error


def _make_decide_core(n: int, k_hi: int, pause: float, fused: bool = False,
                      j_cap: int | None = None):
    """The decide body: ``decide(st, lam_hat, mu_hat, drop_hat, lam0_hat,
    k_current) -> (code, k_next, et_cur, et_target, applied)``.

    Float constants round to the working dtype as the JAX package's weak
    Python constants do: in float32 ``1e-300`` is 0.0 and ``1.0 - 1e-9`` is
    1.0 (torch casts a Python scalar to the tensor's dtype before the op).
    """
    from ..kernels.decide_fused import ops as fused_ops
    from ..kernels.gain_topr import ops as topr_ops
    from .batched import sojourn_table_torch, solve_traffic_batch_torch

    inf = float("inf")

    def decide(st, lam_hat, mu_hat, drop_hat, lam0_hat, k_current):
        routing0 = st["routing0"]
        adj = routing0 > 0
        group = st["group"]
        alpha = st["alpha"]
        active = st["active"]
        src_mask = st["src"]
        k_max = st["k_max"]
        b = lam_hat.shape[0]
        dtype, dev = lam_hat.dtype, lam_hat.device
        mu_eff = mu_hat * st["speed"]
        k_cur = k_current.to(torch.int32)
        # --- overload trigger + capped propagation ------------------------ #
        overloaded = _overloaded(lam_hat, mu_eff, drop_hat, k_cur, group, alpha, active)
        hot = overloaded.any(dim=-1)
        out_c = overloaded
        for _ in range(n):
            out_c = overloaded | (adj & out_c[:, :, None]).any(dim=1)
        capped = (adj & out_c[:, :, None]).any(dim=1) & active

        # --- offered-load clamping ---------------------------------------- #
        lam_src = torch.where(src_mask & torch.isfinite(lam_hat), lam_hat, 0.0)
        total_src = torch.clamp_min(lam_src.sum(dim=-1), 1e-12)
        lam0_cold = torch.where(
            torch.isfinite(lam0_hat)[:, None],
            lam0_hat[:, None] * (lam_src / total_src[:, None]),
            lam_src,
        )
        lam0 = torch.where(src_mask, torch.where(hot[:, None], lam_src, lam0_cold), 0.0)
        colsum = routing0.sum(dim=1)
        inflow = torch.bmm(
            torch.where(active, lam_hat, 0.0)[:, None, :], routing0
        )[:, 0, :]  # einsum bij,bi->bj
        rescale = torch.where(
            (colsum > 0) & ~capped & (inflow > 1e-12)
            & torch.isfinite(lam_hat) & (lam_hat > 0),
            lam_hat / torch.clamp_min(inflow, 1e-300),
            1.0,
        )
        routing = routing0 * rescale[:, None, :]
        lam = solve_traffic_batch_torch(lam0, routing)
        lam = torch.where(active, lam, 0.0)
        ok = torch.isfinite(lam) & (lam >= 0)
        solve_bad = (~ok).any(dim=-1)
        lam = torch.where(ok, lam, 0.0)
        lam0_total = lam0.sum(dim=-1)

        def _et_of(per_op):
            # Shared pricing tail: both decide paths gather raw per-op T
            # values and normalise them here with the same expressions.
            contrib = torch.where(lam > 0, lam * per_op, 0.0)
            return contrib.sum(dim=-1) / torch.clamp_min(lam0_total, 1e-300)

        if fused:
            # --- one pass: table -> gains -> Program (4) -> E[T] ---------- #
            k4, k_start, t_cur_op, t4_op = fused_ops.batch_decide(
                lam, mu_eff, group=group, alpha=alpha, active=active,
                k_cur=k_cur, k_max=k_max, k_hi=k_hi, j_cap=j_cap,
            )
            floor_total = k_start.sum(dim=-1)
        else:
            # --- one table pass: E[T_i](k) and Algorithm-1 gains ---------- #
            T = sojourn_table_torch(
                lam.reshape(-1), mu_eff.reshape(-1), k_hi=k_hi,
                group=group.reshape(-1), alpha=alpha.reshape(-1),
                min_k=torch.ones(b * n, dtype=torch.int32, device=dev),
            ).reshape(b, n, k_hi + 1)
            G = lam[..., None] * (T[..., :-1] - T[..., 1:])
            G = torch.where(torch.isfinite(T[..., :-1]), G, inf)

            # Minimal feasible allocation = first finite table column
            # (argmax over uint8: the CPU argmax takes no bool tensors).
            finite = torch.isfinite(T)
            has_finite = finite.any(dim=-1)
            first = torch.argmax(finite.to(torch.uint8), dim=-1).to(torch.int32)
            k_start = torch.where(
                active, torch.where(has_finite, first, k_hi + 1), 0
            ).to(torch.int32)
            floor_total = k_start.sum(dim=-1)

            # --- Program (4): masked top-R over the gain table ------------ #
            budget = torch.clamp_min(k_max.to(torch.int64) - floor_total, 0).to(torch.int32)
            j = torch.arange(k_hi, dtype=torch.int64, device=dev)
            idx = k_start[..., None].to(torch.int64) + j[None, None, :]
            cand = torch.gather(G, -1, torch.clamp(idx, 0, k_hi - 1))
            cand = torch.where(
                (idx < k_hi) & active[..., None] & torch.isfinite(cand), cand, 0.0
            ).contiguous()
            take = topr_ops.gain_topr(cand, budget)
            k4 = k_start + take

            def _gather(k_vec):
                return torch.gather(
                    T, -1, torch.clamp(k_vec.to(torch.int64), 0, k_hi)[..., None]
                )[..., 0]

            t_cur_op = _gather(k_cur)
            t4_op = _gather(k4)
        infeasible = solve_bad | (floor_total > k_max)

        et_cur = _et_of(t_cur_op)
        et4 = _et_of(t4_op)

        # --- gates (improvement + cost/benefit) ---------------------------- #
        unchanged = torch.where(active, k4 == k_cur, True).all(dim=-1)
        improvement = torch.where(
            torch.isfinite(et_cur) & (et_cur > 0), (et_cur - et4) / et_cur, inf
        )
        visit = lam / torch.clamp_min(lam0_total, 1e-300)[:, None]
        cap_new = torch.where(
            active, k4.to(dtype) * mu_eff / torch.clamp_min(visit, 1e-12), inf
        ).amin(dim=-1)
        slack = torch.clamp_min(cap_new - lam0_total, 1e-9)
        drain = lam0_total * pause / slack
        benefit = torch.where(torch.isfinite(et_cur), et_cur - et4, inf)
        worthwhile = benefit * lam0_total * st["horizon"] > (
            (pause + drain) * torch.clamp_min(lam0_total, 1.0)
        )
        rebalance = (
            ~unchanged
            & (improvement >= st["min_improvement"])
            & (worthwhile | ~torch.isfinite(et_cur))
        )

        # --- action selection (precedence mirrors the twin) --------------- #
        complete = (
            torch.where(active, torch.isfinite(lam_hat) & torch.isfinite(mu_hat), True)
            .all(dim=-1)
            & torch.isfinite(lam0_hat)
        )
        feasible4 = ~infeasible

        code = rebalance.to(torch.int32) * _CODE["rebalance"]  # else "none" (0)
        code = torch.where((infeasible & ~hot) | (solve_bad & hot), _CODE["infeasible"], code)
        code = torch.where(hot & ~solve_bad, _CODE["overloaded"], code)
        code = torch.where(~complete, _CODE["none"], code)
        apply_mask = complete & ~solve_bad & feasible4 & (hot | rebalance)
        k_next = torch.where(apply_mask[:, None], k4, k_cur)
        return code, k_next, et_cur, torch.where(feasible4, et4, inf), apply_mask

    return decide


def _resolve(device, dtype):
    dev = resolve_device(device)
    return dev, (torch.float32 if dtype is None else dtype)


def make_decide(static: ControllerStatic, params: ControllerParams, *,
                k_hi: int | None = None, pause_seconds: float | None = None,
                fused: bool | None = None, compact=None, mesh=None, device=None, dtype=None):
    """The batched decide over one fleet.

    Returns ``decide(lam_hat, mu_hat, drop_hat, lam0_hat, k_current) ->
    (action_code [B] int32, k_next [B, N] int32, et_cur [B], et_target [B],
    applied [B] bool)``; inputs may be numpy arrays or tensors.  ``fused``
    (default: ``params.fused_decide``) routes Program 4 through
    ``kernels/decide_fused`` instead of the two-pass ``erlang_c`` ->
    ``gain_topr`` path.  ``device`` defaults to the CUDA device (raising
    when there is none); ``dtype`` to float32.

    ``compact`` (True or a :class:`CompactionConfig`) returns the sparse
    decide instead: ``decide(lam_hat, mu_hat, drop_hat, lam0_hat,
    k_current, cache) -> (outputs, repriced [B] bool, cache')`` with
    ``decide.init_cache()`` the cold cache; its outputs equal the dense
    decide's bitwise.  Each call reads the repriced count back to the host
    once, to pick the rung.

    ``mesh`` (a 1-D :class:`~repro_torch.distributed.FleetMesh`) shards the
    batch axis over its ranks: every rank passes the whole fleet's inputs,
    decides its own lane shard (B padded to a multiple of the rank count
    with :func:`pad_static` lanes) and returns the whole fleet's outputs,
    gathered and cut back to B.  Every op of the decide is per lane, so the
    outputs equal the unsharded decide's.  With ``compact`` each rank
    compacts its own shard on a ladder of its shard's extent, and the cache
    a rank holds is its shard of the padded-extent cache.  ``device``
    defaults to the mesh's.
    """
    dev, dtype = _resolve(mesh.device if device is None and mesh is not None else device,
                          dtype)
    b, n = static.batch, static.n
    k_hi = int(k_hi if k_hi is not None else max(int(params.k_max.max()), 1))
    pause = float(PAUSE_SECONDS if pause_seconds is None else pause_seconds)
    if fused is None:
        fused = bool(params.fused_decide)
    # Candidate-window bound of the fused path: every Program-4 budget is
    # <= its k_max, so the fleet max keeps the truncation exact.
    j_cap = min(k_hi, max(int(params.k_max.max()), 1))
    core = _make_decide_core(n, k_hi, pause, fused=fused, j_cap=j_cap)
    lanes = slice(0, b)
    if mesh is not None:
        _, n_shards = _mesh_axis(mesh)
        b_pad = _padded_batch(b, n_shards)
        static, params = pad_static(static, b_pad), pad_params(params, b_pad)
        lanes = mesh.shard(b_pad)
    st = _decide_statics(static, params, device=dev, dtype=dtype)
    if mesh is not None:
        st = _lanes(st, lanes)
    b_local = lanes.stop - lanes.start

    def shard(x, fill, dt):
        """The rank's lanes of a whole-fleet input, inert lanes past B."""
        x = torch.as_tensor(x, device=dev).to(dt)
        if mesh is None:
            return x
        if x.shape[0] < static.batch:
            x = torch.cat([x, torch.full((static.batch - x.shape[0],) + tuple(x.shape[1:]),
                                         fill, dtype=dt, device=dev)])
        return x[lanes]

    def inputs(lam_hat, mu_hat, drop_hat, lam0_hat, k_current):
        return (shard(lam_hat, 0.0, dtype), shard(mu_hat, 1.0, dtype),
                shard(drop_hat, 0.0, dtype), shard(lam0_hat, 0.0, dtype),
                shard(k_current, 0, torch.int32))

    def whole(outs):
        """The whole fleet's outputs from every rank's shard, cut to B."""
        if mesh is None:
            return outs
        return tuple(mesh.all_gather(o)[:b] for o in outs)

    if compact:
        core_c = _make_compact_decide(core, b_local, _resolve_ladder(compact, b_local))

        def decide_compact(lam_hat, mu_hat, drop_hat, lam0_hat, k_current, cache):
            outs, repriced, cache = core_c(
                st, *inputs(lam_hat, mu_hat, drop_hat, lam0_hat, k_current), cache)
            outs, (repriced,) = whole(outs), whole((repriced,))
            return outs, repriced, cache

        decide_compact.init_cache = lambda: init_decide_cache(b_local, n, dtype=dtype,
                                                              device=dev)
        return decide_compact

    def decide(lam_hat, mu_hat, drop_hat, lam0_hat, k_current):
        return whole(core(st, *inputs(lam_hat, mu_hat, drop_hat, lam0_hat, k_current)))

    return decide


class ControllerState(NamedTuple):
    """The fused loop's carry.

    ``tick`` is the index of the next control window (a host int, so
    advancing needs no device sync); :meth:`FusedLoop.run` advances any
    number of ticks from it.  ``acc`` holds the post-warmup run aggregates
    (offered, served, dropped, ext_admitted, ext_offered, q_int, q_max).
    ``fstate`` is the forecast state (history window and error tracker)
    when the loop is proactive, else empty.  The loop updates the ``[B,
    N]`` buffers in place (the JAX package donates them to XLA for the same
    effect): keep using the state a run returns, never the one passed in.
    """

    q: Any  # [B, N] queue backlog
    served_prev: Any  # [B, N] last-step completions (the routing delay line)
    k: Any  # [B, N] int32 allocation in force
    acc: tuple  # post-warmup aggregates (7-tuple, see above)
    tick: int  # next control-window index
    fstate: tuple = ()


def init_state(k0, *, device, dtype, fstate: tuple = ()) -> ControllerState:
    """Tick-0 state: empty queues, ``k0`` in force, zero aggregates (and
    the proactive loop's tick-0 forecast state)."""
    k = torch.as_tensor(np.asarray(k0), device=device).to(torch.int32).clone()
    b, n = k.shape

    def zeros2():
        return torch.zeros((b, n), dtype=dtype, device=device)

    def zeros1():
        return torch.zeros(b, dtype=dtype, device=device)

    acc = (zeros2(), zeros2(), zeros2(), zeros1(), zeros1(), zeros2(), zeros2())
    return ControllerState(q=zeros2(), served_prev=zeros2(), k=k, acc=acc, tick=0,
                           fstate=tuple(fstate))


class FusedLoop:
    """simulate -> measure -> decide -> apply over the horizon.

    ``loop(k0)`` runs the whole horizon and returns the output dict;
    ``state = loop.init(k0)`` then ``state, out = loop.run(state, ticks)``
    advances in chunks (per-tick outputs cover the chunk; the aggregates in
    ``state.acc`` cover everything since tick 0).  Under a fleet mesh
    ``init`` and ``run`` keep to this rank's lanes: the carry and the
    outputs cover its ``B_pad / D`` lanes, and :meth:`gather` assembles the
    whole fleet's outputs (cut back to B) on every rank; ``loop(k0)``
    returns them gathered.
    """

    def __init__(self, n_ticks: int, init_fn, run_fn, gather_fn=None):
        self.n_ticks = n_ticks
        self._init_fn = init_fn
        self._run_fn = run_fn
        self._gather_fn = gather_fn

    def init(self, k0) -> ControllerState:
        return self._init_fn(k0)

    def run(self, state: ControllerState, ticks: int | None = None):
        done = int(state.tick)
        ticks = self.n_ticks - done if ticks is None else int(ticks)
        if not 0 < ticks <= self.n_ticks - done:
            raise ValueError(
                f"cannot run {ticks} ticks from tick {done} (horizon {self.n_ticks})"
            )
        return self._run_fn(state, ticks)

    def gather(self, out: dict) -> dict:
        """The whole fleet's outputs from a :meth:`run`'s (the same dict
        without a mesh; under one, a collective every rank calls)."""
        return out if self._gather_fn is None else self._gather_fn(out)

    def __call__(self, k0) -> dict:
        _, out = self.run(self.init(k0), self.n_ticks)
        return self.gather(out)


def make_fused_loop(arrays, static: ControllerStatic, params: ControllerParams, *,
                    steps_per_tick: int, k_hi: int | None = None,
                    warmup_seconds: float | None = None, fused: bool | None = None,
                    proactive=None, compact=None, mesh=None, device=None, dtype=None):
    """Build the control loop over ``arrays`` (a
    :class:`~repro_torch.streaming.batchsim.BatchArrays`).

    Each tick advances one window of ``steps_per_tick`` steps through the
    batch simulator, measures it (Little's law + the Allen-Cunneen wait),
    runs the decide and applies the allocation.  Returns ``(loop,
    n_ticks)``; the per-tick outputs and post-warmup aggregates carry the
    keys of ``repro.core.controller.make_fused_loop``.  ``device`` defaults
    to the CUDA device (raising when there is none), ``dtype`` to float32.

    ``proactive`` (a :class:`~repro_torch.forecast.mpc.MPCConfig`) carries
    the forecast state in ``ControllerState.fstate``: each tick also
    advances the predictors on the window's rates, plans over the horizon
    from the live backlog (:func:`~repro_torch.forecast.mpc.mpc_plan_torch`;
    under the fused decide its allocator is ``kernels/decide_fused`` with
    ``k_cur = 0``) and commits the plan where the confidence gate is open,
    no operator is overloaded and some candidate meets T_max.  Outputs gain
    ``mpc_used`` / ``confident`` per tick.

    ``compact`` (True or a :class:`CompactionConfig`) runs the sparse
    decide: the trigger scan reprices only the lanes whose inputs changed
    (or that are hot), gathered to the smallest ladder rung, and with
    ``proactive`` the planner prices only the commit-eligible lanes.  Every
    output equals the dense loop's bitwise; ``repriced [ticks, B]`` (the
    lanes the decide priced) is a new output, and with ``proactive``
    ``eligible [ticks, B]`` (the lanes the planner priced), a diagnostic
    the reference's loop does not return.  Picking the rungs costs one
    device-to-host read per tick (the two counts together).  The memo cache
    starts cold at every :meth:`FusedLoop.run` call (it is not part of the
    state).

    ``mesh`` (a 1-D :class:`~repro_torch.distributed.FleetMesh`) shards the
    batch axis of the whole loop over its ranks: B is padded to a multiple
    of the rank count with inert lanes (:func:`pad_static`,
    :func:`pad_params`, ``BatchArrays.pad_batch``), and each rank cuts the
    statics, the simulator's arrays, the arrivals and the carry to its lane
    shard and runs the per-lane loop above on it (with ``compact``, on a
    ladder of its shard's extent).  :meth:`FusedLoop.init` and
    :meth:`FusedLoop.run` keep the carry and the per-tick outputs on the
    shard, with no collective; :meth:`FusedLoop.gather` assembles the
    outputs to ``[ticks, B, ...]`` when a caller reports, and
    ``CheckpointStore(mesh=)`` writes the carry in the whole fleet's layout.
    Every op of a tick is per lane, so the gathered outputs equal the
    unsharded loop's.  ``device`` defaults to the mesh's.
    """
    k_top = int(params.k_max.max())
    kw = dict(steps_per_tick=steps_per_tick,
              k_hi=int(k_hi if k_hi is not None else max(k_top, 1)),
              warmup_seconds=warmup_seconds,
              fused=bool(params.fused_decide) if fused is None else fused,
              proactive=proactive, compact=compact, k_top=k_top)
    if mesh is None:
        return _make_lane_loop(arrays, static, params, device=device, dtype=dtype, **kw)
    return _make_sharded_loop(arrays, static, params, mesh,
                              device=mesh.device if device is None else device, dtype=dtype,
                              **kw)


def _cut_lanes(obj, sl: slice):
    """A ``ControllerStatic`` / ``ControllerParams`` / ``BatchArrays`` of
    the lanes ``sl`` (the arrivals' batch axis is their second)."""
    changes = {}
    for fld in dataclasses.fields(obj):
        v = getattr(obj, fld.name)
        if fld.name == "ext":
            changes[fld.name] = v[:, sl]
        elif isinstance(v, np.ndarray) or fld.name in ("names", "allocator"):
            changes[fld.name] = v[sl]
    return replace(obj, **changes)


def _make_sharded_loop(arrays, static: ControllerStatic, params: ControllerParams, mesh, *,
                       device, dtype, proactive, **kw):
    """:func:`make_fused_loop` under a fleet mesh: the per-lane loop on this
    rank's shard.  Its carry and per-tick outputs stay on the shard; the
    loop's :meth:`~FusedLoop.gather` assembles the whole fleet's outputs."""
    dev, dtype = _resolve(device, dtype)
    _mesh_axis(mesh)
    b_real, n = static.batch, static.n
    b_pad = _padded_batch(b_real, mesh.size)
    lanes = mesh.shard(b_pad)
    width = lanes.stop - lanes.start
    static, params = pad_static(static, b_pad), pad_params(params, b_pad)
    arrays = arrays.pad_batch(b_pad)
    inner, n_ticks = _make_lane_loop(
        _cut_lanes(arrays, lanes), _cut_lanes(static, lanes), _cut_lanes(params, lanes),
        proactive=proactive, device=dev, dtype=dtype, **kw)

    def run_fn(state: ControllerState, ticks: int):
        if state.q.shape[0] != width:
            raise ValueError(
                f"this rank's loop runs its {width} lanes, got a carry of {state.q.shape[0]} "
                "(a whole-fleet checkpoint restores onto the shard through "
                "CheckpointStore(mesh=))")
        return inner.run(state, ticks)

    def gather_fn(out: dict) -> dict:
        got = {}
        for key, v in out.items():
            if not isinstance(v, torch.Tensor):
                got[key] = v
            elif key in _AGGREGATE_KEYS or key == "miss":
                got[key] = mesh.all_gather(v)[:b_real]
            else:
                got[key] = mesh.all_gather(v, dim=1)[:, :b_real]
        return got

    def init_fn(k0) -> ControllerState:
        k0 = np.asarray(k0)
        if k0.shape[0] < b_pad:  # padded lanes hold no processors
            k0 = np.concatenate([k0, np.zeros((b_pad - k0.shape[0], n), dtype=k0.dtype)])
        return inner.init(k0[lanes])

    return FusedLoop(n_ticks, init_fn, run_fn, gather_fn), n_ticks


#: The whole-run aggregates of a loop run, in output order: the carry's
#: allocation and backlog, then ``ControllerState.acc``.
_AGGREGATE_KEYS = ("k_final", "q_final", "offered", "served", "dropped", "ext_admitted",
                   "ext_offered", "q_int", "q_max")


def _make_lane_loop(arrays, static: ControllerStatic, params: ControllerParams, *,
                    steps_per_tick: int, k_hi: int, warmup_seconds: float | None,
                    fused: bool, proactive, compact, k_top: int, device, dtype):
    """:func:`make_fused_loop` over the lanes it is given.  ``k_hi`` and
    ``k_top`` (the largest budget) are the whole fleet's, so a shard
    prices with the fleet's table width and candidate window."""
    from ..streaming.batchsim import STATIONARY_K_CAP, composed_wait, window_step_fn

    dev, dtype = _resolve(device, dtype)
    b, n = static.batch, static.n
    dt = float(arrays.dt)
    n_ticks = arrays.steps // steps_per_tick
    k_hi_res = k_hi
    j_cap = min(k_hi_res, max(k_top, 1))
    decide_core = _make_decide_core(n, k_hi_res, PAUSE_SECONDS, fused=fused, j_cap=j_cap)
    window = window_step_fn()
    compact_cfg = None
    if compact:
        compact_cfg = compact if isinstance(compact, CompactionConfig) else CompactionConfig()
        ladder = _resolve_ladder(compact_cfg, b)
        decide_c = _make_compact_decide(decide_core, b, ladder)
    # The largest allocation the loop can apply, a host number: in
    # _make_decide_core (and kernels/decide_fused/ref.py) a lane takes only
    # candidates with `idx < k_hi`, so k4 = k_start + take <= k_hi, but for a
    # lane without a finite table row (`k_start = k_hi + 1`, take 0); and
    # `apply_mask` needs `feasible4`, i.e. `floor_total <= k_max`, so an
    # applied k4 also fits its scenario's k_max.  Otherwise `k_next = k_cur`.
    # A committed MPC plan is built the same way from the same k_hi and
    # needs `floor_total <= k_max` too.  So every tick's k stays <=
    # max(k_apply, k0.max()), and gang lanes serve with k_srv <= 1:
    # stationary_wait's Erlang-B table needs no rows past that (nor past
    # the cap, where the JAX loop stops too).
    k_apply = max(k_hi_res, min(k_hi_res + 1, k_top))
    made = [None, 0]  # the k of the newest state this loop made, its bound

    def bound_of(k_top: int) -> int:
        return min(STATIONARY_K_CAP, max(k_apply, k_top, 1))

    def record(state: ControllerState, k_bound: int) -> ControllerState:
        made[:] = [state.k, k_bound]
        return state

    def f(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype, device=dev)

    st = _decide_statics(static, params, device=dev, dtype=dtype)
    ones = np.ones((arrays.batch, arrays.n))
    mu = f(arrays.mu)  # reference-class priors
    group = torch.as_tensor(np.asarray(arrays.group, dtype=bool), device=dev)
    alpha = f(arrays.alpha)
    cap_queue = f(arrays.cap_queue)
    routing = f(arrays.routing)
    speed = f(static.speed)
    ca2 = f(ones if arrays.ca2 is None else arrays.ca2)
    cs2 = f(ones if arrays.cs2 is None else arrays.cs2)
    mu_eff = mu * speed
    active = st["active"]
    ext_r = f(arrays.ext[: n_ticks * steps_per_tick]).reshape(n_ticks, steps_per_tick, b, n)
    # Step weights staged on the device once; each tick hands the window
    # its row (no host-to-device copy per tick).
    warm_r = f((np.arange(n_ticks * steps_per_tick) >= arrays.warmup_steps).reshape(
        n_ticks, steps_per_tick))
    # A window is warm when it *starts* past the warmup, in seconds.
    warmup_s = arrays.warmup_steps * dt if warmup_seconds is None else float(warmup_seconds)
    tick_warm = np.arange(n_ticks) * steps_per_tick * dt >= warmup_s
    span = steps_per_tick * dt
    # Divisors as device tensors: a CUDA division by a Python scalar is a
    # multiplication by its reciprocal, which would not round like the CPU.
    span_t = torch.tensor(span, dtype=dtype, device=dev)
    spt_t = torch.tensor(float(steps_per_tick), dtype=dtype, device=dev)
    t_max = f(np.nan_to_num(params.t_max, nan=np.inf))
    inf = float("inf")

    if proactive is not None:
        from ..forecast.mpc import forecast_init_state_torch, forecast_step_torch, mpc_plan_torch
        from ..kernels.decide_fused import ops as fused_ops

        def mpc_alloc_of(mu_eff_x, group_x, alpha_x, active_x):
            """The MPC's candidate allocator through the fused decide pass:
            the planner's budgets are absolute totals clipped to [floor,
            k_max], so the pass's own budget ``k_max - floor`` from ``k_cur
            = 0`` is the planner's extra and the takes are the top-R
            route's.  The budget stays <= j_cap, so the kernel's window of
            j_cap cells past the floor holds every take."""
            def alloc(lam_m, budgets_m):
                bx, m = active_x.shape[0], lam_m.shape[0]

                def rep(x):
                    # contiguous: at bx = 1 the reshape is a stride-0 view
                    return x[:, None, :].expand(bx, m // bx, x.shape[-1]).reshape(
                        m, x.shape[-1]).contiguous()

                k4, _, _, _ = fused_ops.batch_decide(
                    lam_m.contiguous(), rep(mu_eff_x), group=rep(group_x), alpha=rep(alpha_x),
                    active=rep(active_x),
                    k_cur=torch.zeros(lam_m.shape, dtype=torch.int32, device=lam_m.device),
                    k_max=budgets_m.to(torch.int32), k_hi=k_hi_res, j_cap=j_cap,
                )
                return k4

            return alloc

        def plan(g, q1, k, lam_pred):
            """The planner over lanes ``g`` (all lanes when None)."""
            def sel(x):
                return x if g is None else x[g]

            alloc = None
            if fused:
                alloc = mpc_alloc_of(sel(mu_eff), sel(group), sel(alpha), sel(active))
            return mpc_plan_torch(
                sel(lam_pred), sel(q1), sel(k), mu=sel(mu), group=sel(st["group"]),
                alpha=sel(alpha), speed=sel(speed), active=sel(active), src_mask=sel(st["src"]),
                cap_queue=sel(cap_queue), t_max=sel(t_max), k_max=sel(st["k_max"]),
                span=span, cfg=proactive, k_hi=k_hi_res, alloc=alloc,
            )

    def capacity_of(k):
        kf = torch.clamp_min(k.to(dtype), 0.0)
        eff = 1.0 / (1.0 + alpha * (kf - 1.0))
        spd = mu * speed
        return torch.where(group, spd * kf * eff, spd * kf)

    def tick_fn(state: ControllerState, t_idx: int, k_bound: int, dcache):
        q, served_prev, k, acc = state.q, state.served_prev, state.k, state.acc
        cap_serve_dt = capacity_of(k) * dt
        (q1, served_prev1, offered, _served, dropped, ext_adm, _ext_off, q_int, q_max,
         w_off, w_srv, w_drop, w_ea, w_eo, w_qi) = window(
            q, served_prev, ext_r[t_idx], warm_r[t_idx], cap_serve_dt, cap_queue, routing,
        )
        # Window measurement: the synthetic snapshot the decide reads.
        lam_hat = offered / span_t
        drop_hat = dropped / span_t
        admitted = torch.clamp_min(lam_hat - drop_hat, 0.0)
        q_mean = q_int / spt_t
        wait = composed_wait(
            q_mean, admitted, dt, span, k, mu, group, alpha, speed, ca2, cs2,
            k_bound=k_bound,
        )
        cap = capacity_of(k)
        svc = torch.where(group, torch.where(cap > 0, 1.0 / cap, inf), 1.0 / mu_eff)
        lam0 = torch.clamp_min(ext_adm / span_t, 0.0)
        contrib = torch.where(admitted > 0, admitted * (wait + svc), 0.0)
        sojourn = torch.where(
            lam0 > 0, contrib.sum(dim=-1) / torch.clamp_min(lam0, 1e-300), float("nan")
        )
        fstate = state.fstate
        if proactive is not None:
            # The forecast plane, and the trigger and completeness the
            # commit gate needs (the decide's own formulas), ahead of the
            # decide so that one host read gives both rungs under compact.
            fstate, lam_pred, conf = forecast_step_torch(fstate, lam_hat, active, proactive)
            hot = _overloaded(lam_hat, mu_eff, drop_hat, k.to(torch.int32), group, alpha,
                              active).any(dim=-1)
            complete = (
                torch.where(active, torch.isfinite(lam_hat) & torch.isfinite(mu), True)
                .all(dim=-1)
                & torch.isfinite(lam0)
            )
            # A plan is committed only where `use` below is open, a subset
            # of this mask: pricing only these lanes is exact.
            eligible = conf & complete & ~hot & torch.isfinite(t_max)
        if compact_cfg is not None:
            k_in = k.to(torch.int32)
            repriced = decide_c.scan(st, lam_hat, mu, drop_hat, lam0, k_in, dcache)
            marks = [repriced] if proactive is None else [repriced, eligible]
            # The tick's one device-to-host read: the rungs' counts.
            counts = torch.stack([m.sum() for m in marks]).tolist()
            (code, k_next, et_cur, et_target, applied), repriced, dcache = decide_c(
                st, lam_hat, mu, drop_hat, lam0, k_in, dcache, repriced=repriced,
                count=counts[0])
        else:
            code, k_next, et_cur, et_target, applied = decide_core(
                st, lam_hat, mu, drop_hat, lam0, k
            )
        if proactive is not None:
            if compact_cfg is not None:
                inf_l = torch.full((b,), inf, dtype=dtype, device=dev)
                k_plan, any_ok, et_hold, et_plan = _bucketed(
                    ladder, b, eligible, counts[1], lambda g: plan(g, q1, k, lam_pred)[:4],
                    (torch.where(active, k, 0), torch.zeros(b, dtype=torch.bool, device=dev),
                     inf_l, inf_l),
                )
            else:
                k_plan, any_ok, et_hold, et_plan, _need = plan(None, q1, k, lam_pred)
            use = conf & any_ok & complete & ~hot & torch.isfinite(t_max)
            changed = use & ((k_plan != k) & active).any(dim=-1)
            k_next = torch.where(use[:, None], torch.where(active, k_plan, k), k_next)
            code = torch.where(use, changed.to(torch.int32) * _CODE["proactive"], code)
            applied = torch.where(use, changed, applied)
            et_cur = torch.where(use, et_hold, et_cur)
            et_target = torch.where(use, et_plan, et_target)
        for a, w in zip(acc[:6], (w_off, w_srv, w_drop, w_ea, w_eo, w_qi)):
            a.add_(w)
        torch.maximum(acc[6], q_max, out=acc[6])
        new_state = ControllerState(q=q1, served_prev=served_prev1, k=k_next, acc=acc,
                                    tick=state.tick + 1, fstate=fstate)
        ys = (code, k_next, sojourn, et_cur, et_target, applied)
        if proactive is not None:
            ys = ys + (use, conf)
        if compact_cfg is not None:
            ys = ys + (repriced,) + (() if proactive is None else (eligible,))
        return new_state, ys, dcache

    def run_fn(state: ControllerState, ticks: int):
        tick0 = state.tick
        if state.k is made[0]:
            k_bound = made[1]
        else:  # a state this loop did not make: one host read of its k
            k_bound = bound_of(int(state.k.max()) if state.k.numel() else 0)
        # The memo starts cold every run: it is not part of the state.
        dcache = None if compact_cfg is None else init_decide_cache(b, n, dtype=dtype,
                                                                    device=dev)
        ys = []
        for t_idx in range(tick0, tick0 + ticks):
            state, y, dcache = tick_fn(state, t_idx, k_bound, dcache)
            ys.append(y)
        record(state, k_bound)
        cols = [torch.stack(col) for col in zip(*ys)]
        codes, k_hist, sojourns, et_cur, et_target, applied = cols[:6]
        warm_flags = torch.as_tensor(tick_warm[tick0:tick0 + ticks], device=dev)
        miss = ((sojourns > t_max[None, :]) & warm_flags[:, None]).sum(dim=0)
        acc = state.acc
        out = {
            "codes": codes, "k": k_hist, "sojourn": sojourns,
            "et_cur": et_cur, "et_target": et_target, "applied": applied,
            "miss": miss, "warm_windows": int(tick_warm[tick0:tick0 + ticks].sum()),
            "k_final": state.k, "q_final": state.q,
            "offered": acc[0], "served": acc[1], "dropped": acc[2],
            "ext_admitted": acc[3], "ext_offered": acc[4],
            "q_int": acc[5], "q_max": acc[6],
        }
        if proactive is not None:
            out["mpc_used"], out["confident"] = cols[6], cols[7]
        if compact_cfg is not None:
            out["repriced"] = cols[8 if proactive is not None else 6]
            if proactive is not None:
                out["eligible"] = cols[9]
        return state, out

    def init_fn(k0) -> ControllerState:
        k_top = int(np.max(np.asarray(k0), initial=0))
        fstate = () if proactive is None else forecast_init_state_torch(
            b, n, proactive, dtype=dtype, device=dev)
        return record(init_state(k0, device=dev, dtype=dtype, fstate=fstate), bound_of(k_top))

    return FusedLoop(n_ticks, init_fn, run_fn), n_ticks


# --------------------------------------------------------------------------- #
# The float64 twin the live scheduler calls (one scenario per call)
# --------------------------------------------------------------------------- #
# Program (4)/(6) solver pairs, keyed like SchedulerConfig.allocator.
ALLOCATORS = {
    "table": (assign_processors_table, min_processors_table),
    "heap": (assign_processors, min_processors),
}


def effective_capacity(k, mu_eff, group, alpha) -> np.ndarray:
    """Per-operator service capacity at allocation ``k`` with the group
    efficiency curve applied (k floored at 1, mirroring the scalar
    ``overloaded_mask``)."""
    k_eff = np.maximum(np.asarray(k, dtype=np.int64), 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        eff = 1.0 / (1.0 + alpha * (k_eff - 1))
    return np.where(group, mu_eff * k_eff * eff, mu_eff * k_eff)


def overloaded_mask_batch(lam_hat, mu_eff, drop, k, group, alpha) -> np.ndarray:
    """[B, N] bool: measured offered load >= capacity, or sustained
    shedding — the vectorized twin of ``DRSScheduler.overloaded_mask``
    (same comparisons, so bit-identical decisions at any batch size)."""
    lam_hat = np.asarray(lam_hat, dtype=np.float64)
    mu_eff = np.asarray(mu_eff, dtype=np.float64)
    drops = np.nan_to_num(np.asarray(drop, dtype=np.float64), nan=0.0)
    capacity = effective_capacity(k, mu_eff, group, alpha)
    valid = np.isfinite(lam_hat) & np.isfinite(mu_eff) & (mu_eff > 0)
    with np.errstate(invalid="ignore"):
        hot = (lam_hat >= capacity * (1.0 - 1e-9)) | (
            drops > DROP_TRIGGER_FRACTION * capacity
        )
    return valid & hot


def capped_mask_batch(overloaded, base_routing, active=None) -> np.ndarray:
    """[B, N] bool: operators whose *measured arrival rate* is throughput-
    capped — transitively downstream of a saturated operator (vectorized
    ``DRSScheduler._capped_mask`` fixed point)."""
    overloaded = np.atleast_2d(np.asarray(overloaded, dtype=bool))
    routing = np.asarray(base_routing, dtype=np.float64)
    if routing.ndim == 2:
        routing = routing[None]
    adj = routing > 0  # [B, N, N]
    n = adj.shape[-1]
    out_capped = overloaded.copy()
    in_capped = np.zeros_like(overloaded)
    for _ in range(n):
        new_in = (adj & out_capped[:, :, None]).any(axis=1)
        new_out = overloaded | new_in
        if (new_in == in_capped).all() and (new_out == out_capped).all():
            break
        in_capped, out_capped = new_in, new_out
    if active is not None:
        in_capped = in_capped & np.asarray(active, dtype=bool)
    return in_capped


def clamp_row(
    names: Sequence[str],
    base_routing: np.ndarray,
    lam_hat: np.ndarray,
    mu_hat: np.ndarray,
    lam0_hat: float,
    overloaded: np.ndarray,
    capped: np.ndarray,
    scaling: Sequence[str],
    group_alpha: Sequence[float],
    speed: np.ndarray | None = None,
) -> Topology:
    """Rebuild one scenario's model from measurements (DESIGN.md §4/§11).

    This is the pure-function extraction of ``DRSScheduler.topology_from``
    — identical float ops, so the rebuilt Topology is bit-identical to the
    pre-extraction scheduler's.  ``speed`` applies machine-class factors
    to the effective per-processor service rates (1.0 = reference class).
    """
    n = len(names)
    hot = bool(np.asarray(overloaded).any())
    lam_hat = np.array(lam_hat, dtype=np.float64)
    lam0 = np.zeros(n)
    in_deg = base_routing.sum(axis=0)
    sources = np.nonzero(in_deg == 0)[0]
    if len(sources) == 0:
        sources = np.array([0])
    if hot:
        for s in sources:
            lam0[s] = lam_hat[s] if math.isfinite(lam_hat[s]) else 0.0
    else:
        src_lam = lam_hat[sources]
        total_src = max(src_lam.sum(), 1e-12)
        for s, l in zip(sources, src_lam):
            lam0[s] = lam0_hat * (l / total_src) if math.isfinite(lam0_hat) else l
    routing = base_routing.copy()
    for j in range(n):
        declared_in = routing[:, j]
        if declared_in.sum() == 0:
            continue
        if capped[j]:
            continue  # measured lam_hat[j] is capacity, not offered load
        inflow = float(np.dot(declared_in, lam_hat))
        if inflow > 1e-12 and math.isfinite(lam_hat[j]) and lam_hat[j] > 0:
            routing[:, j] *= lam_hat[j] / inflow
    ops = [
        OperatorSpec(
            name=names[i],
            mu=float(mu_hat[i]) if speed is None else float(mu_hat[i] * speed[i]),
            scaling=scaling[i],
            group_alpha=group_alpha[i],
        )
        for i in range(n)
    ]
    return Topology(ops, lam0, routing)


@dataclass(frozen=True)
class RowDecision:
    """One scenario's tick outcome (pure data; no scheduler state)."""

    action: str
    k_next: np.ndarray  # allocation in force after the tick
    k_target: np.ndarray | None  # proposed allocation (None on hard failure)
    k_max: int  # budget after any lease change
    et_cur: float
    et_target: float | None
    need_total: int | None  # Program-(6)-sized demand (overload / scaling)
    plan: RebalancePlan | None
    reason: str
    applied: bool  # k_next != entry k (an allocation change to execute)

    @property
    def code(self) -> int:
        return _CODE[self.action]


def _default_cost_plan(
    cost_model: RebalanceCostModel,
    top: Topology,
    k_old: np.ndarray,
    k_new: np.ndarray,
    cache,
    stage_names,
) -> RebalancePlan:
    return cost_model.plan(top, k_old, k_new, cache=cache, stage_names=stage_names)


def decide_single(
    top: Topology,
    k_current: np.ndarray,
    k_max: int,
    *,
    t_max: float | None,
    headroom: float,
    scale_in_hysteresis: float,
    min_improvement: float,
    horizon_seconds: float,
    allocator: str = "table",
    overloaded: np.ndarray | None = None,
    lam_hat: np.ndarray | None = None,
    mu_hat: np.ndarray | None = None,
    drop: np.ndarray | None = None,
    ensure: Callable[[int], int] | None = None,
    cost_model: RebalanceCostModel | None = None,
    cache=None,
    stage_names: Sequence[str] | None = None,
    stragglers: tuple = (),
    names: Sequence[str] | None = None,
) -> RowDecision:
    """One scenario's decide — the float64 numpy twin of the old
    ``DRSScheduler.decide`` body (same branch order, same float ops, same
    allocator calls, so the outcome is bit-identical).

    ``ensure`` is the per-scenario negotiator lease hook (target -> new
    k_max); ``None`` disables the scale-out/scale-in branches exactly
    like a scheduler without a negotiator.  Model/allocator hard failures
    (``UnstableTopologyError`` and uncaught ``InsufficientResourcesError``)
    propagate to the caller, as they did from ``decide``.
    """
    assign_fn, min_proc_fn = ALLOCATORS[allocator]
    names = list(names) if names is not None else [op.name for op in top.operators]
    n = len(names)
    cost_model = cost_model or RebalanceCostModel()
    k_current = np.asarray(k_current, dtype=np.int64)
    et_cur = top.expected_sojourn(k_current)  # may raise UnstableTopologyError

    if overloaded is None:
        if lam_hat is None or mu_hat is None:
            overloaded = np.zeros(n, dtype=bool)
        else:
            group = np.array([op.scaling == "group" for op in top.operators])
            alpha = np.array([op.group_alpha for op in top.operators])
            overloaded = overloaded_mask_batch(
                lam_hat[None], mu_hat[None], None if drop is None else drop[None],
                k_current[None], group[None], alpha[None],
            )[0]

    # --- Overload: defined unstable-snapshot path (no gates) ------------ #
    if overloaded.any():
        hot_names = [names[i] for i in np.nonzero(overloaded)[0]]
        try:
            if t_max is not None:
                need_total = math.ceil(min_proc_fn(top, t_max).total * headroom)
            else:
                need_total = math.ceil(
                    int(top.min_feasible_allocation().sum()) * headroom
                )
        except (InsufficientResourcesError, UnstableTopologyError):
            need_total = k_max + 1
        if need_total > k_max and ensure is not None:
            k_max = max(k_max, ensure(need_total))
        try:
            best = assign_fn(top, k_max)
        except (InsufficientResourcesError, UnstableTopologyError) as e:
            return RowDecision(
                "overloaded", k_current.copy(), None, k_max, et_cur, None,
                need_total, None,
                f"overloaded at {hot_names}; offered load infeasible "
                f"within k_max={k_max}: {e}",
                applied=False,
            )
        return RowDecision(
            "overloaded", best.k.copy(), best.k, k_max, et_cur,
            best.expected_sojourn, need_total, None,
            f"measured rho >= 1 at {hot_names}; offered-load model "
            f"needs {need_total}, reallocated within k_max={k_max}",
            applied=True,
        )

    # --- Program (6): how many processors do we actually need? ---------- #
    need: AllocationResult | None = None
    if t_max is not None:
        try:
            need = min_proc_fn(top, t_max)
        except InsufficientResourcesError:
            need = None

    if t_max is not None:
        needed_total = (
            math.ceil(need.total * headroom) if need is not None else k_max + 1
        )
        # Scale out: T_max unreachable within the current lease.
        if needed_total > k_max and ensure is not None:
            new_k_max = ensure(needed_total)
            if new_k_max > k_max:
                k_max = new_k_max
                best = assign_fn(top, k_max)
                return RowDecision(
                    "scale_out", best.k.copy(), best.k, k_max, et_cur,
                    best.expected_sojourn, needed_total, None,
                    f"Program(6) needs {needed_total} > leased; "
                    f"negotiated k_max={k_max}",
                    applied=True,
                )
        # Scale in: we need much less than we lease (with hysteresis).
        if (
            need is not None
            and ensure is not None
            and math.ceil(need.total * headroom) < scale_in_hysteresis * k_max
        ):
            target_total = math.ceil(need.total * headroom)
            new_k_max = ensure(target_total)
            if new_k_max < k_max:
                best = assign_fn(top, new_k_max)
                return RowDecision(
                    "scale_in", best.k.copy(), best.k, new_k_max, et_cur,
                    best.expected_sojourn, target_total, None,
                    f"Program(6) needs {need.total} (headroom "
                    f"{target_total}) << leased {k_max}; released to {new_k_max}",
                    applied=True,
                )

    # --- Program (4): best placement within k_max ----------------------- #
    try:
        best = assign_fn(top, k_max)
    except InsufficientResourcesError as e:
        return RowDecision(
            "infeasible", k_current.copy(), None, k_max, et_cur, None,
            None if need is None else need.total, None, str(e), applied=False,
        )

    improvement = (
        (et_cur - best.expected_sojourn) / et_cur
        if math.isfinite(et_cur) and et_cur > 0
        else float("inf")
    )
    if np.array_equal(best.k, k_current) or improvement < min_improvement:
        return _none_or_hint_row(
            k_current, best, k_max, et_cur, stragglers,
            reason=f"improvement {improvement:.1%} < {min_improvement:.0%}",
        )

    plan = _default_cost_plan(cost_model, top, k_current, best.k, cache, stage_names)
    if not plan.worthwhile(horizon_seconds, top.lam0_total) and math.isfinite(et_cur):
        return _none_or_hint_row(
            k_current, best, k_max, et_cur, stragglers, plan=plan,
            reason="rebalance cost exceeds benefit over horizon",
        )
    return RowDecision(
        "rebalance", best.k.copy(), best.k, k_max, et_cur,
        best.expected_sojourn, None, plan, "", applied=True,
    )


def _none_or_hint_row(
    k_current, best, k_max, et_cur, stragglers, *, plan=None, reason=""
) -> RowDecision:
    action = "none"
    if stragglers:
        action = "rebalance_hint"
        named = ", ".join(f"{op}[{inst}]" for op, inst in stragglers)
        reason = (reason + "; " if reason else "") + f"stragglers flagged: {named}"
    return RowDecision(
        action, np.asarray(k_current, dtype=np.int64).copy(), best.k, k_max,
        et_cur, best.expected_sojourn, None, plan, reason, applied=False,
    )


@dataclass
class BatchDecision:
    """Stacked tick outcomes for a B-scenario batch."""

    rows: list  # [B] RowDecision
    errors: list  # [B] Exception | None (model/allocator hard failures)

    @property
    def actions(self) -> list[str]:
        return [r.action for r in self.rows]


def tick_batch(
    meas,
    k_current: np.ndarray,
    static: ControllerStatic,
    params: ControllerParams,
    *,
    ensure: Sequence[Callable[[int], int] | None] | None = None,
    cost_models: Sequence[RebalanceCostModel | None] | None = None,
    raise_errors: bool = False,
    proactive=None,
    q_backlog: np.ndarray | None = None,
    compact_state: TwinCompactionState | None = None,
) -> BatchDecision:
    """One control tick for the whole batch (the float64 numpy twin).

    ``meas`` is a :class:`~repro_torch.core.measurer.MeasurementBatch`.
    Vectorized across ``[B, N]``: snapshot completeness, the overload
    trigger and the throughput-capped propagation.  Per scenario: the
    offered-load clamping, the Jackson solve, Programs (4)/(6) and the
    negotiator and cost calls (:func:`decide_single`).  Model hard
    failures become per-row ``errors`` with an ``"infeasible"`` row, or
    propagate with ``raise_errors`` (the scalar scheduler's semantics).
    ``ensure[b]`` is scenario b's lease hook (target -> new k_max),
    ``cost_models[b]`` its cost model.

    ``proactive`` (a :class:`~repro_torch.forecast.mpc.ProactiveController`)
    switches on the forecast/MPC plane: the predictors advance every tick,
    and scenarios whose forecast passes the confidence gate, whose snapshot
    is complete, that are not overloaded and have a T_max commit the MPC
    plan instead of the reactive decide; with lease hooks, the leases
    follow the plan's demand (one re-plan when one moves).  ``q_backlog [B,
    N]`` seeds the planner's rollout (0 without it).

    ``compact_state`` (a caller-owned :class:`TwinCompactionState`) replays
    the cached row of a lane whose decide inputs are bitwise unchanged and
    that is not hot, has no lease hook or custom cost model; with
    ``proactive`` the planner prices only the commit-eligible lanes.  The
    decisions are the same either way; the ``need`` diagnostic is 0 on
    unpriced lanes.  ``raise_errors`` callers never replay.
    """
    b, n = static.batch, static.n
    k_current = np.asarray(k_current, dtype=np.int64)
    mu_eff = meas.mu_hat * static.speed
    overloaded = overloaded_mask_batch(
        meas.lam_hat, mu_eff, meas.drop_hat, k_current, static.group, static.alpha
    ) & static.active
    hot = overloaded.any(axis=1)
    capped = np.zeros((b, n), dtype=bool)
    if hot.any():
        capped = capped_mask_batch(overloaded, static.base_routing, static.active)
    complete = meas.complete(static.active)

    use = np.zeros(b, dtype=bool)
    k_plan = et_hold = et_plan = need_mpc = None
    if proactive is not None:
        from ..forecast.mpc import forecast_step, mpc_plan, mpc_plan_compact

        t_arr = np.nan_to_num(params.t_max, nan=np.inf)
        k_hi = int(max(params.k_max.max(), k_current.max(), 1))
        q0 = (np.zeros((b, n)) if q_backlog is None
              else np.asarray(q_backlog, dtype=np.float64))
        proactive.state, lam_pred, conf = forecast_step(
            proactive.state, meas.lam_hat, static.active, proactive.cfg
        )
        plan_kw = dict(
            mu=np.asarray(meas.mu_hat, dtype=np.float64),
            group=static.group, alpha=static.alpha, speed=static.speed,
            active=static.active, src_mask=_source_mask(static),
            cap_queue=proactive.cap_queue, t_max=t_arr,
            span=proactive.span, cfg=proactive.cfg, k_hi=k_hi,
        )
        # A plan can be committed only where the gate is open, the
        # snapshot complete, the trigger quiet and T_max real: under
        # compaction the planner prices exactly that set.
        eligible = conf & complete & ~hot & np.isfinite(t_arr)

        def _plan(k_max_arr):
            if compact_state is None:
                return mpc_plan(lam_pred, q0, k_current, k_max=k_max_arr, **plan_kw)
            return mpc_plan_compact(eligible, lam_pred, q0, k_current, k_max=k_max_arr,
                                    **plan_kw)

        k_maxes = params.k_max.astype(np.int64).copy()
        k_plan, any_ok, et_hold, et_plan, need_mpc = _plan(k_maxes)
        use = conf & any_ok & complete & ~hot & np.isfinite(t_arr)
        # Leases grow toward the plan's demand and are released (with
        # hysteresis) when it shrinks; one re-plan if any moved.
        if ensure is not None:
            hyst = proactive.cfg.scale_in_hysteresis
            moved = False
            for bi in range(b):
                hook = ensure[bi]
                if hook is None or not use[bi]:
                    continue
                tgt, lease = int(need_mpc[bi]), int(k_maxes[bi])
                if tgt > lease or tgt < hyst * lease:
                    new_lease = int(hook(max(tgt, 1)))
                    if new_lease != lease:
                        k_maxes[bi] = new_lease
                        moved = True
            if moved:
                k_plan, any_ok, et_hold, et_plan, need_mpc = _plan(k_maxes)
                use = conf & any_ok & complete & ~hot & np.isfinite(t_arr)
        proactive.mpc_used = use.copy()
        proactive.confident = conf.copy()
        proactive.need = np.asarray(need_mpc).copy()

    rows: list[RowDecision] = []
    errors: list = [None] * b
    if compact_state is not None:
        compact_state.replayed[:] = False
    for bi in range(b):
        ni = int(static.n_ops[bi])
        k_row = k_current[bi, :ni]
        k_max = int(params.k_max[bi])
        if ni == 0:
            # A padded batch lane: no operators, always "none".
            rows.append(RowDecision(
                "none", k_row.copy(), None, k_max, float("nan"), None, None,
                None, "padded lane", applied=False,
            ))
            continue
        if use[bi]:
            k_new = np.asarray(k_plan[bi, :ni], dtype=np.int64)
            changed = bool((k_new != k_row).any())
            rows.append(RowDecision(
                "proactive" if changed else "none",
                k_new.copy() if changed else k_row.copy(),
                k_new, int(k_maxes[bi]), float(et_hold[bi]), float(et_plan[bi]),
                int(need_mpc[bi]), None,
                "MPC plan committed ahead of trigger" if changed else "proactive hold",
                applied=changed,
            ))
            continue
        if not complete[bi]:
            rows.append(RowDecision(
                "none", k_row.copy(), None, k_max, float("nan"), None, None,
                None, "insufficient measurements", applied=False,
            ))
            continue
        # The sparse decide's replay: hot lanes always reprice; hooked and
        # custom-cost lanes never memoize.
        memo = (
            compact_state is not None
            and not raise_errors
            and (ensure is None or ensure[bi] is None)
            and (cost_models is None or cost_models[bi] is None)
        )
        lam_row = np.asarray(meas.lam_hat[bi, :ni], dtype=np.float64)
        mu_row = np.asarray(meas.mu_hat[bi, :ni], dtype=np.float64)
        drop_row = np.asarray(meas.drop_hat[bi, :ni], dtype=np.float64)
        lam0_sc = float(meas.lam0_hat[bi])
        if (
            memo
            and not overloaded[bi, :ni].any()
            and compact_state.hit(bi, lam_row, mu_row, drop_row, lam0_sc, k_row, k_max)
        ):
            cached = compact_state.rows[bi]
            rows.append(replace(cached, k_next=cached.k_next.copy()))
            errors[bi] = compact_state.errors[bi]
            compact_state.replayed[bi] = True
            continue
        names = static.names[bi]
        scaling = ["group" if g else "replica" for g in static.group[bi, :ni]]
        t_max = params.t_max[bi]
        try:
            top = clamp_row(
                names,
                static.base_routing[bi, :ni, :ni],
                meas.lam_hat[bi, :ni],
                meas.mu_hat[bi, :ni],
                float(meas.lam0_hat[bi]),
                overloaded[bi, :ni],
                capped[bi, :ni],
                scaling,
                static.alpha[bi, :ni],
                speed=None if np.all(static.speed[bi, :ni] == 1.0)
                else static.speed[bi, :ni],
            )
            row = decide_single(
                top,
                k_row,
                k_max,
                t_max=None if math.isnan(t_max) else float(t_max),
                headroom=float(params.headroom[bi]),
                scale_in_hysteresis=float(params.scale_in_hysteresis[bi]),
                min_improvement=float(params.min_improvement[bi]),
                horizon_seconds=float(params.horizon_seconds[bi]),
                allocator=params.allocator[bi],
                overloaded=overloaded[bi, :ni],
                ensure=None if ensure is None else ensure[bi],
                cost_model=None if cost_models is None else cost_models[bi],
                names=names,
            )
        except (InsufficientResourcesError, UnstableTopologyError) as e:
            if raise_errors:
                raise
            errors[bi] = e
            row = RowDecision(
                "infeasible", k_row.copy(), None, k_max, float("inf"), None,
                None, None, str(e), applied=False,
            )
        rows.append(row)
        if memo and not overloaded[bi, :ni].any():
            compact_state.remember(bi, lam_row, mu_row, drop_row, lam0_sc, k_row.copy(),
                                   k_max, row, errors[bi])
    return BatchDecision(rows, errors)
