"""How ``correct`` is decided: the outputs of the timed path against the
float32 reference, number by number, each against its cell's limit.

The numbers (the smaller the better; each limit in ``workloads/<cell>.json``):

``kv_err``      the cache rows the timed calls wrote, against the
                reference's keys (after the rotation) and values: the worst
                layer's relative L2 error, keys and values apart.
``logits_err``  (prefill) the logits of each prompt's last position: the
                worst prompt's relative L2 error.
``token_gap``   (decode) the widest gap by which a served token's logit
                lies below the reference's best at that position, the
                reference fed the prompt and the served tokens.
``route_gap``   (mixture of experts) the widest gap by which an expert the
                program chose lies below the reference's k-th best router
                logit for that token.
``kept_wrong``  (mixture of experts) the (token, slot) pairs whose kept flag
                differs from the capacity rule applied to the program's own
                choices, in every call of the run (limit 0).

For a mixture of experts the reference follows the program's routing, and
``route_gap`` and ``kept_wrong`` check that routing on their own: a bf16
program's router logits lie within rounding of the reference's, and where
two experts' logits tie that close, a free-running float32 reference would
route the token elsewhere and judge the rounding as a fault.
"""

from __future__ import annotations

import torch

from ..reference import model as ref


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.to(torch.float32), b.to(torch.float32)
    return float(torch.linalg.vector_norm(a - b) / torch.clamp(torch.linalg.vector_norm(b),
                                                               min=1e-30))


def route_gap(logits: torch.Tensor, experts: torch.Tensor) -> float:
    """logits [.., E] (the reference's), experts [.., k] (the judged side's)."""
    k = experts.shape[-1]
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    chosen = torch.gather(logits, -1, experts.to(torch.int64))
    return float(torch.clamp(kth - chosen, min=0).max())


def kept_wrong(records: list, n_experts: int, cf: float) -> int:
    """Pairs whose kept flag breaks the capacity rule.  ``records``: one list
    a call, each with one dict a layer holding ``experts`` / ``kept`` [T, k]
    in the call's token order."""
    if not records:
        return 0
    wrong = 0
    for layer in range(len(records[0])):
        ex = torch.cat([r[layer]["experts"] for r in records])
        kept = torch.cat([r[layer]["kept"] for r in records])
        group = torch.cat([torch.full((r[layer]["experts"].shape[0],), i, device=ex.device)
                           for i, r in enumerate(records)])
        order = torch.cat([torch.arange(r[layer]["experts"].shape[0], device=ex.device)
                           for r in records])
        want = ref.capacity_keep(ex, group, order, n_experts, cf)
        wrong += int((want != kept.to(torch.bool)).sum())
    return wrong


class _KV:
    """Compares each layer's judged keys / values with the reference's and
    keeps the routing gaps."""

    def __init__(self, judged_kv, rows: slice, judged_experts=None):
        self.judged_kv, self.rows, self.experts = judged_kv, rows, judged_experts
        self.kv = 0.0
        self.route = 0.0

    def __call__(self, i, out: ref.LayerOut):
        jk, jv = self.judged_kv(i)
        self.kv = max(self.kv, rel_err(jk, out.k[:, self.rows]), rel_err(jv, out.v[:, self.rows]))
        if out.router_logits is not None and self.experts is not None:
            self.route = max(self.route, route_gap(out.router_logits, self.experts[i]))


def judge_prefill(params, shape: ref.Shape, tokens, logits, judged_kv, experts=None) -> dict:
    """tokens [B, S]; logits [B, V] the judged last-position logits;
    ``judged_kv(i)`` layer i's judged keys and values [B, S, Hkv, Dh];
    ``experts``: per layer (experts, kept) [B, S, k] for the reference to
    follow."""
    cmp = _KV(judged_kv, slice(None), None if experts is None else [e for e, _ in experts])
    want = ref.forward(params, shape, tokens, routing=experts, on_layer=cmp)[:, 0]
    out = {"kv_err": cmp.kv, "logits_err": max(rel_err(logits[i], want[i])
                                               for i in range(want.shape[0]))}
    if experts is not None:
        out["route_gap"] = cmp.route
    return out


def judge_decode(params, shape: ref.Shape, seqs, served, p: int, judged_kv, experts=None) -> dict:
    """seqs [n, P + N]: each sampled session's prompt and the N tokens its
    steps took in; served [n, N]: the tokens the steps gave out (the next
    step's inputs, and one more); ``judged_kv(i)`` layer i's rows P..P+N-1
    [n, N, Hkv, Dh]; ``experts``: per layer (experts, kept) [n, P + N, k]."""
    n, total = seqs.shape
    steps = total - p
    at = torch.arange(p, total, device=seqs.device)[None].expand(n, steps)
    cmp = _KV(judged_kv, slice(p, total), None if experts is None else [e for e, _ in experts])
    want = ref.forward(params, shape, seqs, logits_at=at, routing=experts, on_layer=cmp)
    best = want.max(dim=-1).values
    gap = best - torch.gather(want, -1, served[..., None].to(torch.int64))[..., 0]
    out = {"kv_err": cmp.kv, "token_gap": float(gap.max())}
    if experts is not None:
        out["route_gap"] = cmp.route
    return out


def verdict(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(every reading within its limit, {name: [reading, limit]}); a reading
    with no limit, or a limit with no reading, is not correct."""
    names = sorted(set(readings) | set(limits))
    table = {k: [readings.get(k), limits.get(k)] for k in names}
    ok = all(r is not None and lim is not None and r <= lim for r, lim in table.values())
    return ok, table
