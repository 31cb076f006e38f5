"""The plain reference decoder: dense (phi3-style) and mixture-of-experts
(mixtral-style) layers, in float32 with TF32 off, or in float8 for the
check's control.

It follows the published architecture: RMS norms with a weight, grouped-query
attention with rotary position embeddings (the rotation over the two halves
of each head, as the Hugging Face Llama / Phi-3 / Mixtral code applies it),
causal over every earlier position or over a sliding window (query ``i``
sees the keys ``j > i - window``, as the Hugging Face mask reads a
configuration's ``sliding_window``), a SwiGLU FFN, and for a mixture of
experts a router whose top-k logits are renormalised by a softmax, with a
fixed number of slots per expert in each call (the pairs past it dropped,
earlier tokens first).  It imports nothing of the program: it reads the
weights as the benchmark drew them (upcast to float32 one layer, or one
expert, at a time) and the tokens as the benchmark made or the program
served them.

:func:`forward` runs all its sequences together, one layer at a time, so
that a layer's float32 weights are the most it holds beside the bf16 ones.
Routing: where ``routing`` is given (each layer's experts and kept flags,
per token) the experts are those; else the layer routes on its own logits,
in the groups ``groups`` says (a call of the program each), capacity and
drops as :func:`capacity_keep` sets them.

``precision="fp8"`` is the control: every product's operands rounded to
float8 e4m3 (weights with one scale per tensor, activations one per row),
and q, k and v too, the sums in float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

F8_MAX = 448.0


def exact_matmul() -> None:
    """float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def q8(t: torch.Tensor, per_row: bool) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with a scale per row (activations) or
    per tensor (weights), back in float32."""
    a = t.abs().amax(dim=-1, keepdim=True) if per_row else t.abs().amax()
    s = torch.clamp(a, min=1e-30) / F8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


@dataclass(frozen=True)
class Shape:
    d: int
    hq: int
    hkv: int
    dh: int
    vocab: int
    layers: int
    experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    rope_theta: float = 10000.0
    eps: float = 1e-5
    window: int | None = None


class _Math:
    def __init__(self, precision: str):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.fp8 = precision == "fp8"

    def w(self, t: torch.Tensor) -> torch.Tensor:
        t = t.to(torch.float32)
        return q8(t, False) if self.fp8 else t

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x [.., K] @ w [K, N] (w already through :meth:`w`)."""
        return (q8(x, True) if self.fp8 else x) @ w

    def act(self, t: torch.Tensor) -> torch.Tensor:
        return q8(t, True) if self.fp8 else t


def rms_norm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w.to(torch.float32)


def rope_tables(positions: torch.Tensor, dh: int, theta: float):
    """cos, sin [.., Dh / 2] at ``positions``, the angles in float64."""
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float64, device=positions.device)
                           / dh))
    ang = positions.to(torch.float64)[..., None] * inv
    return torch.cos(ang).to(torch.float32), torch.sin(ang).to(torch.float32)


def rope(x, cos, sin):
    """x [B, S, H, Dh]; cos / sin [B, S, Dh / 2]."""
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[:, :, None], sin[:, :, None]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def attention(q, k, v, hq: int, hkv: int, fm: _Math, window: int | None = None):
    """Causal attention: q [B, S, Hq, Dh], k / v [B, S, Hkv, Dh] -> [B, S,
    Hq, Dh], one (sequence, KV head) at a time; with a ``window`` query i
    sees the keys i - window < j <= i."""
    b, s, _, dh = q.shape
    rep = hq // hkv
    q, k, v = fm.act(q), fm.act(k), fm.act(v)
    out = torch.empty_like(q)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril_()
    if window is not None:
        mask.triu_(1 - window)
    for i in range(b):
        for g in range(hkv):
            qg = q[i, :, g * rep:(g + 1) * rep].transpose(0, 1)  # [rep, S, Dh]
            sc = (qg @ k[i, :, g].T) / math.sqrt(dh)
            sc.masked_fill_(~mask, float("-inf"))
            p = torch.softmax(sc, dim=-1)
            out[i, :, g * rep:(g + 1) * rep] = (p @ v[i, :, g]).transpose(0, 1)
    return out


def capacity(cf: float, tokens: int, k: int, e: int) -> int:
    """Slots per expert in a call over ``tokens`` tokens."""
    return max(1, int(cf * tokens * k / e))


def capacity_keep(experts: torch.Tensor, group: torch.Tensor, order: torch.Tensor, n_experts: int,
                  cf: float) -> torch.Tensor:
    """Kept flags [N, k] of the (token, slot) pairs ``experts`` [N, k]: in each
    call (``group`` [N]) each expert keeps its first ``capacity`` pairs, the
    pairs ordered by the token's place in the call (``order`` [N]) and then
    by slot."""
    n, k = experts.shape
    dev = experts.device
    sizes = torch.bincount(group)
    pair_group = group[:, None].expand(n, k).reshape(-1)
    pair_pos = (order[:, None] * k + torch.arange(k, device=dev)).reshape(-1)
    run = pair_group * n_experts + experts.reshape(-1)
    key = run * (int(pair_pos.max()) + 1) + pair_pos
    idx = torch.argsort(key)
    srun = run[idx]
    first = torch.ones_like(srun, dtype=torch.bool)
    first[1:] = srun[1:] != srun[:-1]
    starts = torch.nonzero(first)[:, 0]
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    rank_sorted = torch.arange(srun.numel(), device=dev) - starts[seg]
    rank = torch.empty_like(rank_sorted)
    rank[idx] = rank_sorted
    caps = torch.tensor([capacity(cf, int(t), k, n_experts) for t in sizes.tolist()],
                        device=dev)
    return (rank < caps[pair_group]).reshape(n, k)


@dataclass
class LayerOut:
    """What one layer gives a caller: its keys (after the rotation) and
    values [B, S, Hkv, Dh], and, for a mixture of experts, its router logits
    [B, S, E] and the experts and kept flags it used [B, S, k]."""

    k: torch.Tensor
    v: torch.Tensor
    router_logits: torch.Tensor | None = None
    experts: torch.Tensor | None = None
    kept: torch.Tensor | None = None


def _ffn_dense(lw, h, fm: _Math, chunk: int = 4096):
    wg, wu, wo = fm.w(lw["wi_gate"]), fm.w(lw["wi_up"]), fm.w(lw["wo_ffn"])
    flat = h.reshape(-1, h.shape[-1])
    out = torch.empty_like(flat)
    for i in range(0, flat.shape[0], chunk):
        x = flat[i:i + chunk]
        a = torch.nn.functional.silu(fm.mm(x, wg)) * fm.mm(x, wu)
        out[i:i + chunk] = fm.mm(a, wo)
    return out.reshape(h.shape)


def _ffn_moe(lw, h, m: Shape, fm: _Math, routing, groups):
    b, s, d = h.shape
    flat = h.reshape(-1, d)
    logits = fm.mm(flat, fm.w(lw["router"]))  # [N, E]
    if routing is not None:
        experts, kept = (t.reshape(-1, m.top_k) for t in routing)
    else:
        experts = torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :m.top_k]
        group, order = (t.reshape(-1) for t in groups)
        kept = capacity_keep(experts, group, order, m.experts, m.capacity_factor)
    weights = torch.softmax(torch.gather(logits, 1, experts), dim=-1)
    out = torch.zeros_like(flat)
    for e in range(m.experts):
        tok, slot = torch.nonzero((experts == e) & kept, as_tuple=True)
        if tok.numel() == 0:
            continue
        x = flat[tok]
        a = (torch.nn.functional.silu(fm.mm(x, fm.w(lw["moe_wi_gate"][e])))
             * fm.mm(x, fm.w(lw["moe_wi_up"][e])))
        y = fm.mm(a, fm.w(lw["moe_wo"][e]))
        out.index_add_(0, tok, y * weights[tok, slot][:, None])
    return (out.reshape(b, s, d), logits.reshape(b, s, -1), experts.reshape(b, s, -1),
            kept.reshape(b, s, -1))


def forward(params: dict, m: Shape, tokens: torch.Tensor, *, precision: str = "fp32",
            logits_at: torch.Tensor | None = None, routing=None, groups=None, on_layer=None):
    """Run ``tokens`` [B, S] (positions 0..S-1) through the decoder.

    ``logits_at`` [B, n]: the positions whose next-token logits to return
    ([B, n, V] float32; default: the last).  ``routing``: per layer a pair
    (experts, kept) [B, S, k] to follow; ``groups``: a pair (call, place in
    the call) [B, S] of int64 for a mixture of experts that routes itself.
    ``on_layer(i, LayerOut)`` sees each layer's keys, values and routing."""
    exact_matmul()
    fm = _Math(precision)
    lay = params["layers"]
    b, s = tokens.shape
    dev = tokens.device
    x = params["embed"][tokens].to(torch.float32)
    pos = torch.arange(s, device=dev)[None].expand(b, s)
    cos, sin = rope_tables(pos, m.dh, m.rope_theta)
    for i in range(m.layers):
        lw = {k: v[i] for k, v in lay.items()}
        h = rms_norm(x, lw["attn_norm"], m.eps)
        q = fm.mm(h, fm.w(lw["wq"])).reshape(b, s, m.hq, m.dh)
        k = fm.mm(h, fm.w(lw["wk"])).reshape(b, s, m.hkv, m.dh)
        v = fm.mm(h, fm.w(lw["wv"])).reshape(b, s, m.hkv, m.dh)
        q, k = rope(q, cos, sin), rope(k, cos, sin)
        o = attention(q, k, v, m.hq, m.hkv, fm, m.window)
        x = x + fm.mm(o.reshape(b, s, m.hq * m.dh), fm.w(lw["wo"]))
        del q, o
        h = rms_norm(x, lw["ffn_norm"], m.eps)
        out = LayerOut(fm.act(k), fm.act(v))
        if m.experts:
            y, out.router_logits, out.experts, out.kept = _ffn_moe(
                lw, h, m, fm, None if routing is None else routing[i], groups)
        else:
            y = _ffn_dense(lw, h, fm)
        x = x + y
        del h, y
        if on_layer is not None:
            on_layer(i, out)
        del out, k, v
    if logits_at is None:
        logits_at = torch.full((b, 1), s - 1, device=dev)
    xs = torch.gather(x, 1, logits_at[..., None].expand(-1, -1, m.d))
    return fm.mm(rms_norm(xs, params["final_norm"], m.eps), fm.w(params["lm_head"]))
