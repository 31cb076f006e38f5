"""The float32 reference against the port's plain (CPU) path at the two
configurations' smoke sizes (their ``smoke()`` in ``repro_torch.configs``):
prefill logits and cache, then decode steps through the cache, all in
float32; the capacity rule against the port's own kept flags; the float8
control far from both."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from bench.harness import program
from bench.harness.weights import draw
from bench.reference import model as ref

from ._tiny import tiny


SMOKE = {"phi3-prefill-4x4096": "phi3_medium_14b", "mixtral-prefill-4x4096": "mixtral_8x22b"}


def _setup(name):
    """The cell at the port's smoke sizes for its configuration (full
    attention; the benchmark's capacity, so that pairs drop)."""
    import importlib

    smoke = importlib.import_module(f"repro_torch.configs.{SMOKE[name]}").smoke()
    cell = tiny(name)
    cell.config.update(hidden_size=smoke.d_model, num_attention_heads=smoke.n_heads,
                       num_key_value_heads=smoke.n_kv_heads, num_hidden_layers=smoke.n_layers,
                       intermediate_size=smoke.d_ff, vocab_size=smoke.vocab)
    if smoke.n_experts:
        cell.config.update(num_local_experts=smoke.n_experts, num_experts_per_tok=smoke.top_k)
    cfg = dataclasses.replace(program.model_config(cell.config), dtype=torch.float32)
    params = draw(cell.dims, 2**35 + 11, "cpu", torch.float32)
    return cell, cfg, params, program.reference_shape(cell.config)


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("name", sorted(SMOKE))
def test_reference_matches_the_port_in_float32(name):
    cell, cfg, params, shape = _setup(name)
    serve = program.api()
    gen = torch.Generator().manual_seed(7)
    b, p, steps = 3, 24, 5
    tokens = torch.randint(0, shape.vocab, (b, p + steps), generator=gen)
    cache = serve.init_cache(cfg, b, p + steps, device="cpu")
    routing = [] if shape.experts else None
    logits, cache = serve.prefill(params, cfg, {"tokens": tokens[:, :p]}, cache, device="cpu",
                                  routing=routing)
    step_logits = []
    for j in range(steps):
        rec = [] if shape.experts else None
        out, cache = serve.decode_step(params, cfg, tokens[:, p + j], cache, device="cpu",
                                       routing=rec)
        step_logits.append(out)
        if rec is not None:
            for layer, r in zip(routing, rec):  # position-major records -> [B, S, k]
                layer.setdefault("steps", []).append(r)
    forced = None
    if shape.experts:
        forced = []
        for layer in routing:
            e = [layer["experts"].reshape(b, p, -1)] + [r["experts"][:, None]
                                                       for r in layer["steps"]]
            k = [layer["kept"].reshape(b, p, -1)] + [r["kept"][:, None] for r in layer["steps"]]
            forced.append((torch.cat(e, 1), torch.cat(k, 1)))
    kv = {}
    at = torch.arange(p - 1, p + steps)[None].expand(b, steps + 1)
    want = ref.forward(params, shape, tokens, logits_at=at, routing=forced,
                       on_layer=lambda i, o: kv.__setitem__(i, (o.k, o.v, o.router_logits)))
    got = torch.stack([logits] + step_logits, dim=1)
    assert _rel(got, want) < 1e-4
    for i in range(shape.layers):
        assert _rel(cache["k"][i], kv[i][0]) < 1e-4
        assert _rel(cache["v"][i], kv[i][1]) < 1e-4
        if shape.experts:  # the port chose the reference's top-k
            from bench.harness.check import route_gap
            assert route_gap(kv[i][2], forced[i][0]) < 1e-4


def test_capacity_rule_matches_the_port():
    """``capacity_keep`` against the port's ``moe_layer`` kept flags in a
    regime that drops: one call, tokens in the call's order."""
    from repro_torch.models.common import ModelConfig
    from repro_torch.models.ffn import moe_layer

    cfg = ModelConfig(arch="t", family="moe", n_layers=1, d_model=32, n_heads=2, n_kv_heads=1,
                      d_ff=48, vocab=64, n_experts=4, top_k=2, capacity_factor=0.75,
                      dtype=torch.float32)
    gen = torch.Generator().manual_seed(3)
    p = {"router": torch.randn(32, 4, generator=gen),
         "wi_gate": torch.randn(4, 32, 48, generator=gen),
         "wi_up": torch.randn(4, 32, 48, generator=gen),
         "wo": torch.randn(4, 48, 32, generator=gen)}
    x = torch.randn(3, 20, 32, generator=gen)
    rec = {}
    moe_layer(p, x, cfg, rec)
    n = rec["experts"].shape[0]
    kept = ref.capacity_keep(rec["experts"], torch.zeros(n, dtype=torch.int64),
                             torch.arange(n), 4, 0.75)
    assert not bool(rec["kept"].all())
    assert torch.equal(kept, rec["kept"])


def test_fp8_control_is_far_from_float32():
    cell, cfg, params, shape = _setup("mixtral-prefill-4x4096")
    tokens = torch.randint(0, shape.vocab, (2, 32), generator=torch.Generator().manual_seed(1))
    groups = (torch.zeros_like(tokens), torch.arange(64).reshape(2, 32))
    a = ref.forward(params, shape, tokens, groups=groups)
    b = ref.forward(params, shape, tokens, groups=groups, precision="fp8")
    assert _rel(b, a) > 0.03
