"""The check's control: the reference in float8 put in the program's place,
judged as the program is.  For prefill it reads the same prompts; for decode
the same prompts and served tokens, and at each position the token that
float8 puts first stands for the served one.  A mixture of experts routes
itself in the calls the program made (each prefill group, each step over
every session), and the float32 reference follows that routing."""

from __future__ import annotations

import torch

from ..reference import model as ref
from . import check, program


def readings(cell, params, sample: dict) -> dict:
    shape = program.reference_shape(cell.config)
    moe = cell.dims.experts > 0
    kept: dict = {}
    if "tokens" in sample:
        tokens = sample["tokens"]
        b, s = tokens.shape
        groups = (torch.zeros_like(tokens), torch.arange(b * s, device=tokens.device).reshape(b, s))

        def keep(i, o):
            kept[i] = (o.k, o.v, o.experts, o.kept)

        logits = ref.forward(params, shape, tokens, precision="fp8", groups=groups,
                             on_layer=keep)[:, 0]
        experts = [kept[i][2:] for i in range(shape.layers)] if moe else None
        return check.judge_prefill(params, shape, tokens, logits, lambda i: kept[i][:2], experts)
    p, pick = sample["p"], sample["pick"]
    seqs = sample["seqs"]
    if moe:  # every session, so that each call's capacity is the program's
        x = torch.cat([sample["prompts"], sample["inputs"]], dim=1)
        rows = pick
    else:
        x, rows = seqs, torch.arange(seqs.shape[0], device=seqs.device)
    b, total = x.shape
    dev = x.device
    g = cell.traffic.get("prefill_group", b)
    bi = torch.arange(b, device=dev)[:, None].expand(b, total)
    si = torch.arange(total, device=dev)[None].expand(b, total)
    group = torch.where(si < p, bi // g, b + si)
    order = torch.where(si < p, (bi % g) * p + si, bi)
    at = torch.arange(p, total, device=dev)[None].expand(b, total - p)

    def keep_rows(i, o):
        kept[i] = (o.k[rows, p:], o.v[rows, p:],
                   None if o.experts is None else o.experts[rows],
                   None if o.kept is None else o.kept[rows])

    logits = ref.forward(params, shape, x, precision="fp8", logits_at=at, groups=(group, order),
                         on_layer=keep_rows)
    served = logits[rows].argmax(-1)
    del logits
    experts = [kept[i][2:] for i in range(shape.layers)] if moe else None
    return check.judge_decode(params, shape, seqs, served, p, lambda i: kept[i][:2], experts)
