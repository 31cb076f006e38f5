"""Feed-forward layers (the port of ``repro/models/ffn.py``): SwiGLU and
capacity-based top-k MoE, on one device and expert-parallel.

``swiglu`` runs through ``kernels/swiglu``, so it has that kernel's
numerics: on the card the TPU kernel's (gate and up products in float32,
the hidden rounded once), on the CPU the kernel reference's (gate and up
rounded to the activation dtype first).  The reference model's own
``ffn.swiglu`` rounds ``silu(gate)`` and the product separately; in bf16
the three differ by bf16 rounding, in float32 they agree (ROADMAP Queue 3).
kimi-k2's shared expert goes through the same ``swiglu``.

The MoE dispatch is the reference's: sort the (token, slot) pairs by
expert (a stable sort), keep the first ``capacity`` pairs of each
expert's run, run the experts as batched products over a ``[E, C, D]``
buffer, and sum each token's ``k`` weighted results.  The routed experts'
products are the reference's ``einsum``s (outside any Pallas kernel).  On
the card, outside autograd, in bf16 and at a capacity of more than two
row tiles (``kernels/moe_experts.MIN_SLOTS`` slots an expert or more),
:func:`moe_layer` runs them as the grouped kernels of
``kernels/moe_experts``: two launches that read each expert's filled-slot
count on the card and run only the row tiles holding a filled slot, the
gate's SiLU in the first one's epilogue, rounded as :func:`_experts`
rounds.  Every other caller -- a decode step's few slots and any call of
two tiles an expert or fewer (where the kernels' whole tiles cost what the
skip saves: up to 9 % slower, ``MIN_SLOTS``), training under autograd,
the meta dry-run (which counts the padded products, as the reference's
``einsum`` does), CPU tensors and :func:`moe_layer_ep` -- runs
:func:`_experts`' ``torch.bmm`` products over every slot.  The buffer is
built by a gather (each slot names the
token that fills it, or a zero row) and the results are gathered back per
(token, slot) pair and summed over the ``k`` slots in slot order, so no
step accumulates with atomics: the dispatch is deterministic on the card,
and its backward (the gathers' accumulating ``index_put_``) runs under
``torch.use_deterministic_algorithms``.

:func:`moe_layer_ep` is the expert-parallel form (the reference's
``shard_map`` body) on ``torch.distributed``: the "data" mesh axis is
``ep_group``, the optional "model" axis ``tp_group``; the collectives are
the autograd-aware ones of ``torch.distributed.nn.functional``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import obs
from ..kernels import moe_experts
from ..kernels.swiglu import ops as swiglu_ops
from .common import ModelConfig

__all__ = ["swiglu", "router_top_k", "moe_layer", "moe_layer_ep", "moe_capacity", "EPGroups",
           "ep_groups", "ep_shard"]


def swiglu(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x [.., D] with params wi_gate [D, F], wi_up [D, F], wo [F, D]."""
    lead = x.shape[:-1]
    out = swiglu_ops.swiglu(x.reshape(-1, x.shape[-1]), params["wi_gate"], params["wi_up"],
                            params["wo"])
    return out.reshape(*lead, out.shape[-1])


def router_top_k(logits: torch.Tensor, top_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Token router: logits [T, E] -> (weights [T, k] float32, experts [T, k]):
    the softmax over the k largest logits (Mixtral's renormalisation).  Of
    equal logits the lower expert comes first, as ``jax.lax.top_k`` orders
    them (a stable descending sort; ``torch.topk`` promises no order, and
    logits rounded from bf16 tie often)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return torch.softmax(vals[:, :top_k].to(torch.float32), dim=-1), idx[:, :top_k]


def moe_capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert for a call over ``tokens`` tokens: the reference's
    ``max(1, int(capacity_factor * T * k / E))``, in Python floats."""
    return max(1, int(cfg.capacity_factor * tokens * cfg.top_k / cfg.n_experts))


def _aux_loss(logits: torch.Tensor, experts: torch.Tensor, n_experts: int, mean=None):
    """Switch Transformer eq. 4 with the top-1 one-hot: E times the sum of
    the mean router probability and the top-1 share per expert; ``mean``
    averages each over the ranks of a group (the reference's ``pmean``)."""
    me = torch.softmax(logits, dim=-1).mean(dim=0)
    ce = F.one_hot(experts[:, 0], n_experts).to(torch.float32).mean(dim=0)
    if mean is not None:
        me, ce = mean(me), mean(ce)
    return n_experts * torch.sum(me * ce)


def _runs(keys: torch.Tensor, n: int):
    """Stable sort of ``keys`` [P] (values in [0, n]) -> (order, sorted keys,
    each run's start [n], each pair's rank in its run [P] in the original
    order)."""
    sk, order = torch.sort(keys, stable=True)
    start = torch.searchsorted(sk, torch.arange(n, device=keys.device), side="left")
    inv = torch.empty_like(order).scatter_(0, order, torch.arange(order.numel(),
                                                                  device=keys.device))
    rank = inv - start[keys.clamp(max=n - 1)]
    return order, sk, start, rank


def _slot_sources(order, sk, start, n: int, cap: int, empty: int):
    """[n * cap] source rows of a capacity buffer: slot (e, c) holds the
    sorted pair ``start[e] + c`` when that pair is in run ``e`` (its first
    ``cap`` pairs), else ``empty`` (a zero row)."""
    dev = order.device
    c = torch.arange(cap, device=dev)
    idx = (start[:, None] + c).clamp(max=order.numel() - 1)  # [n, cap]
    filled = sk[idx] == torch.arange(n, device=dev)[:, None]
    return torch.where(filled, order[idx], empty).reshape(-1)


def _filled(start, pairs: int, cap: int) -> torch.Tensor:
    """[E] int32 on ``start``'s device: each expert's filled slots, its run
    of sorted pairs (``start`` from :func:`_runs` over ``pairs`` pairs) cut
    at the capacity ``cap``.  No host sync."""
    ends = torch.cat([start[1:], start.new_full((1,), pairs)])
    return (ends - start).clamp_(max=cap).to(torch.int32)


def _grouped(buf, *weights) -> bool:
    """Whether the experts' products take the grouped kernels: bf16 CUDA
    tensors outside autograd, at least ``moe_experts.MIN_SLOTS`` slots an
    expert."""
    return (buf.is_cuda and buf.dtype == torch.bfloat16
            and buf.shape[1] >= moe_experts.MIN_SLOTS
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in (buf, *weights))))


def _experts(buf, wg, wu, wo):
    """[E, C, D] through each expert's SwiGLU -> [E, C, D]: the reference's
    rounding (silu of the float32 gate, rounded to the activation dtype,
    times ``up``).  Outside autograd the float32 gate is activated in
    place, and ``up`` is formed once the gate is rounded: at kimi-k2's
    prefill one [384, 426, 2048] float32 block less is live at once."""
    g = torch.bmm(buf, wg).to(torch.float32)
    h = F.silu(g, inplace=not torch.is_grad_enabled()).to(buf.dtype)
    del g
    return torch.bmm(h * torch.bmm(buf, wu), wo)


def _pad_row(x):
    """x [N, D] with a zero row appended (the source of empty slots)."""
    return torch.cat([x, x.new_zeros(1, x.shape[1])])


def _combine(vals, keep, weights, t: int, k: int):
    """Each token's ``k`` results [T * k, D] (pair order: token-major),
    weighted (``weights`` rounded to the activation dtype first), dropped
    pairs zeroed, summed over the slots in slot order."""
    vals = vals * weights.reshape(-1, 1).to(vals.dtype)
    vals = torch.where(keep[:, None], vals, torch.zeros((), dtype=vals.dtype,
                                                        device=vals.device))
    vals = vals.reshape(t, k, -1)
    out = vals[:, 0]
    for j in range(1, k):
        out = out + vals[:, j]
    return out


def moe_layer(params: dict, x: torch.Tensor, cfg: ModelConfig,
              routing: dict | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE with a fixed capacity per expert: x [B, S, D] -> (out [B, S,
    D], aux []).  ``params``: ``router`` [D, E], ``wi_gate`` / ``wi_up`` [E,
    D, F], ``wo`` [E, F, D], and ``shared`` (``wi_gate`` / ``wi_up`` / ``wo``)
    for kimi-k2's shared expert.  Pairs past an expert's capacity are
    dropped, as the reference drops them.  When ``routing`` is a dict it
    receives this call's ``experts`` [T, k], ``kept`` [T, k] (bool) and
    ``margin`` [T] (float32: the k-th router logit less the (k+1)-th, the
    closest a token is to another route)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    cap = moe_capacity(cfg, t)
    xf = x.reshape(t, d)
    logits = (xf @ params["router"]).to(torch.float32)  # [T, E]
    weights, experts = router_top_k(logits, k)
    aux = _aux_loss(logits, experts, e)

    flat = experts.reshape(-1)  # [T * k], token-major
    order, sk, start, rank = _runs(flat, e)
    keep = rank < cap
    src = _slot_sources(order // k, sk, start, e, cap, t)
    buf = _pad_row(xf)[src].reshape(e, cap, d)
    w = params["wi_gate"], params["wi_up"], params["wo"]
    counts = _filled(start, t * k, cap) if _grouped(buf, *w) else None
    with obs.span("moe.experts"):
        out_e = _experts(buf, *w) if counts is None else moe_experts.experts(buf, *w, counts)
    # Only filled slots are read: a dropped pair's clamped rank is its
    # expert's last slot, which is filled when the expert overflows.
    vals = out_e.reshape(e * cap, d)[flat * cap + rank.clamp(max=cap - 1)]
    out = _combine(vals, keep, weights, t, k)
    obs.count("moe.pairs_kept", keep)
    obs.count("moe.pairs_routed", t * k)
    if buf.is_cuda and obs.enabled():  # the card's products (a CPU record: the pairs' alone)
        obs.count("moe.slots", e * cap)
        obs.count("moe.slots_run", e * cap if counts is None else moe_experts.run_rows(counts, cap))
    if cfg.n_shared_experts > 0:
        out = out + swiglu(params["shared"], xf)
    if routing is not None:
        top = torch.sort(logits, dim=-1, descending=True).values
        routing.update(experts=experts, kept=keep.reshape(t, k),
                       margin=top[:, k - 1] - top[:, k] if k < e else
                       torch.full((t,), float("inf"), device=x.device))
    return out.reshape(b, s, d), aux


# --------------------------------------------------------------------------- #
# Expert parallelism on torch.distributed
# --------------------------------------------------------------------------- #
class EPGroups(NamedTuple):
    """The process groups of expert parallelism: ``ep`` (the reference's
    "data" mesh axis: each rank holds its batch shard and ``E / n_ep``
    experts) and ``tp`` (its "model" axis: a slice of ``d_ff``; None for
    one)."""

    ep: object
    tp: object = None


def ep_groups(n_ep: int, n_tp: int = 1) -> tuple[EPGroups, int, int]:
    """Every rank's groups on an ``(n_ep, n_tp)`` mesh of the default group
    (rank = data index x ``n_tp`` + model index, the reference's
    ``make_mesh((n_ep, n_tp), ("data", "model"))`` order); returns (this
    rank's groups, its data index, its model index).  Every rank calls it
    (``new_group`` is collective)."""
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    if n_ep * n_tp != world:
        raise ValueError(f"ep_groups: a {n_ep} x {n_tp} mesh needs {n_ep * n_tp} ranks, "
                         f"not {world}")
    ep = tp = None
    for j in range(n_tp):
        g = dist.new_group([i * n_tp + j for i in range(n_ep)])
        if rank % n_tp == j:
            ep = g
    for i in range(n_ep):
        g = dist.new_group([i * n_tp + j for j in range(n_tp)]) if n_tp > 1 else None
        if rank // n_tp == i:
            tp = g
    return EPGroups(ep, tp), rank // n_tp, rank % n_tp


def ep_shard(params: dict, cfg: ModelConfig, ep_index: int, n_ep: int, tp_index: int = 0,
             n_tp: int = 1) -> dict:
    """A rank's slice of MoE parameters (one layer's, or stacked ``[L, ...]``
    ones): its ``E / n_ep`` experts and, with ``n_tp`` > 1, its slice of
    the experts' and the shared expert's ``d_ff``; the router whole."""

    def cut(w, axis, n, i):
        size = w.shape[axis] // n
        return w.narrow(axis, i * size, size).contiguous()

    f = cfg.expert_ff
    if cfg.n_experts % n_ep or f % n_tp:
        raise ValueError(f"ep_shard: {cfg.n_experts} experts over {n_ep} ranks, d_ff {f} "
                         f"over {n_tp}")
    out = {"router": params["router"]}
    for key, f_axis in (("wi_gate", -1), ("wi_up", -1), ("wo", -2)):
        out[key] = cut(cut(params[key], -3, n_ep, ep_index), f_axis, n_tp, tp_index)
    if "shared" in params:
        if (f * cfg.n_shared_experts) % n_tp:
            raise ValueError(f"ep_shard: shared d_ff {f * cfg.n_shared_experts} over {n_tp}")
        sh = params["shared"]
        out["shared"] = {"wi_gate": cut(sh["wi_gate"], -1, n_tp, tp_index),
                         "wi_up": cut(sh["wi_up"], -1, n_tp, tp_index),
                         "wo": cut(sh["wo"], -2, n_tp, tp_index)}
    return out


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def moe_layer_ep(params: dict, x: torch.Tensor, cfg: ModelConfig,
                 groups: EPGroups | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE: each rank's batch shard x [B_loc, S, D] and its
    :func:`ep_shard` of the parameters -> (its out [B_loc, S, D], aux []).

    Per rank, as the reference's ``shard_map`` body: route the local
    tokens; sort the pairs by the rank owning their expert into a send
    buffer [n_ep, C, D] of fixed capacity (``C = round_up(max(int(cf * T *
    k / n_ep), 8), 8)``) with each slot's local expert id (``E_loc`` marks
    an empty one); ``all_to_all`` over ``groups.ep``; dispatch the received
    slots to [E_loc, C2, D] (``C2 = round_up(max(int(cf * n_ep * C /
    E_loc), 8), 8)``); the experts' products (a ``d_ff`` slice each on
    ``groups.tp``); back by ``all_to_all``; combine on the home rank; add
    the shared expert; sum over ``groups.tp``.  The aux loss averages the
    two per-expert means over ``groups.ep`` before their product.  Pairs
    past either capacity drop.  Without groups, or when ``n_experts`` is
    not a multiple of the EP size, it is :func:`moe_layer` on full
    parameters (the reference's own fallback)."""
    import torch.distributed as dist
    import torch.distributed.nn.functional as dfn

    if groups is None or groups.ep is None:
        return moe_layer(params, x, cfg)
    n_ep = dist.get_world_size(groups.ep)
    if cfg.n_experts % n_ep:
        return moe_layer(params, x, cfg)
    e_loc = cfg.n_experts // n_ep
    k = cfg.top_k
    b_loc, s, d = x.shape
    t = b_loc * s
    xf = x.reshape(t, d)
    logits = (xf @ params["router"]).to(torch.float32)  # [T, E] (global experts)
    weights, experts = router_top_k(logits, k)
    aux = _aux_loss(logits, experts, cfg.n_experts,
                    mean=lambda v: dfn.all_reduce(v, group=groups.ep) / n_ep)

    flat = experts.reshape(-1)
    dest, local_e = flat // e_loc, flat % e_loc
    cap = _round_up(max(int(cfg.capacity_factor * t * k / n_ep), 8), 8)
    order, sk, start, rank = _runs(dest, n_ep)
    keep = rank < cap
    src = _slot_sources(order, sk, start, n_ep, cap, t * k)  # a pair, or t * k: empty
    send_x = _pad_row(xf)[torch.where(src < t * k, src // k, t)]
    send_le = torch.cat([local_e, local_e.new_full((1,), e_loc)])[src]
    recv_x = dfn.all_to_all_single(torch.empty_like(send_x), send_x, group=groups.ep)
    recv_le = torch.empty_like(send_le)
    dist.all_to_all_single(recv_le, send_le, group=groups.ep)

    rows = recv_le.numel()  # n_ep * cap, in source-rank order
    c2 = _round_up(max(int(cfg.capacity_factor * n_ep * cap / e_loc), 8), 8)
    order2, sk2, start2, rank2 = _runs(recv_le, e_loc)  # empty slots (e_loc) sort last
    keep2 = (rank2 < c2) & (recv_le < e_loc)
    src2 = _slot_sources(order2, sk2, start2, e_loc, c2, rows)
    buf = _pad_row(recv_x)[src2].reshape(e_loc, c2, d)
    out_e = _experts(buf, params["wi_gate"], params["wi_up"], params["wo"])  # partial over F
    back = out_e.reshape(e_loc * c2, d)[recv_le.clamp(max=e_loc - 1) * c2
                                        + rank2.clamp(max=c2 - 1)]
    back = torch.where(keep2[:, None], back, torch.zeros((), dtype=back.dtype,
                                                         device=back.device))
    ret_x = dfn.all_to_all_single(torch.empty_like(back), back, group=groups.ep)

    vals = ret_x[dest * cap + rank.clamp(max=cap - 1)]
    out = _combine(vals, keep, weights, t, k)
    if cfg.n_shared_experts > 0:
        out = out + swiglu(params["shared"], xf)  # partial over the shared d_ff
    if groups.tp is not None:
        out = dfn.all_reduce(out, group=groups.tp)
    return out.reshape(b_loc, s, d), aux
