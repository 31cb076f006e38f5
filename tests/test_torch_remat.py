"""Per-layer rematerialisation in the port's training forward
(``models/transformer.py:_run_layer``), on the CPU.

The reference wraps five layer bodies in ``jax.checkpoint(body,
prevent_cse=False)`` (``src/repro/models/transformer.py:250, 333, 406, 449,
478``): the decoder's attention + FFN layer, rwkv6's time-mix +
channel-mix, zamba2's norm + mamba2 mixer, whisper's encoder layer and its
decoder layer.  The port runs the same five through
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` when
autograd records them, and nothing else (zamba2's shared block stays
outside, as in the reference).  Held here, with the checkpoint replaced by
a direct call through ``monkeypatch`` for the un-rematerialised step:

* every family (dense, moe, vlm, ssm, hybrid, audio) at 2 layers (zamba2
  with a shared-block site after each, so the un-rematerialised block sits
  between rematerialised ones; whisper 2 + 2), float32: the gradients of
  ``loss_fn`` and one ``make_train_step`` step's new parameters bitwise
  equal to the direct calls', and the checkpointed bodies exactly the
  family's layers, each once;
* serving (``prefill``, ``decode_step``, under ``torch.no_grad()``) calls
  no checkpoint;
* the bytes autograd saves in the forward (read with
  ``torch.autograd.graph.saved_tensors_hooks``, each storage once, the
  parameters left out) fall to those the step saves outside the
  rematerialised bodies -- the embedding, zamba2's shared block, the final
  norm, the head and the loss -- plus the bodies' inputs: ``outside <=
  remat <= outside + inputs``, with ``remat`` below the direct step's
  ``outside + inside``;
* ``forward(..., routing=)`` under autograd records each MoE layer once,
  and the backward's recompute leaves the records as the forward made them.

The expert-parallel train step on gloo ranks is in
``tests/test_torch_moe_ep.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint as real_checkpoint

from repro_torch.configs import get_config
from repro_torch.models import serve
from repro_torch.models import transformer as tr
from repro_torch.models.common import mrope_positions
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_step import TrainState, make_train_step
from repro_torch.tree import flatten_with_paths, unflatten

FAMILIES = {"dense": "llama3.2-1b", "moe": "mixtral-8x22b", "vlm": "qwen2-vl-2b",
            "ssm": "rwkv6-1.6b", "hybrid": "zamba2-7b", "audio": "whisper-medium"}
#: The bodies each family rematerialises, in call order, at 2 layers.
BODIES = {"dense": ["_decoder_layer"] * 2, "moe": ["_decoder_layer"] * 2,
          "vlm": ["_decoder_layer"] * 2, "ssm": ["_rwkv_layer"] * 2,
          "hybrid": ["_mamba_layer"] * 2,
          "audio": ["_whisper_enc_layer"] * 2 + ["_whisper_dec_layer"] * 2}
B, S = 2, 128


def _config(family: str):
    cfg = dataclasses.replace(get_config(FAMILIES[family], "smoke"), n_layers=2,
                              dtype=torch.float32)
    if family == "hybrid":
        cfg = dataclasses.replace(cfg, hybrid_attn_every=1)
    if family == "audio":
        cfg = dataclasses.replace(cfg, enc_layers=2)
    return cfg


def _batch(cfg, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))),
           "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))}
    if cfg.family == "vlm":
        out["patch_embeds"] = torch.from_numpy(
            rng.standard_normal((B, 4, cfg.d_model)).astype(np.float32))
        out["positions_3d"] = mrope_positions(B, 4, S)
    if cfg.family == "audio":
        out["frames"] = torch.from_numpy(
            rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    return out


def _params(cfg):
    params = tr.init_params(cfg, seed=1, device="cpu")
    if "w_lora_b" in params.get("layers", {}):  # rwkv6's zero LoRA factor: give it a gradient
        lora_b = params["layers"]["w_lora_b"]
        lora_b.copy_(torch.randn(lora_b.shape, generator=torch.Generator().manual_seed(3)) * 0.1)
    return params


def _leaves(params):
    paths = flatten_with_paths(params)
    leaves = [p.detach().requires_grad_() for _k, p in paths]
    return unflatten(params, {k: t for (k, _p), t in zip(paths, leaves)}), leaves


def _gradients(cfg, params, batch):
    tree, leaves = _leaves(params)
    total, _ = tr.loss_fn(tree, cfg, batch)
    return total.detach(), torch.autograd.grad(total, leaves)


def _direct(fn, *args, **_kw):
    return fn(*args)


def _recording(names: list):
    """A checkpoint that records the name of each body it wraps."""
    def ckpt(fn, *args, **kw):
        names.append(fn.__name__)
        return real_checkpoint(fn, *args, **kw)
    return ckpt


@pytest.mark.parametrize("family", list(FAMILIES))
def test_gradients_and_step_equal_the_direct_calls_bit_for_bit(family, monkeypatch):
    cfg = _config(family)
    params, batch = _params(cfg), _batch(cfg)
    names = []
    monkeypatch.setattr(tr, "checkpoint", _recording(names))
    loss, grads = _gradients(cfg, params, batch)
    assert names == BODIES[family]
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, decay_steps=10)

    def step():
        p = {k: t.clone() for k, t in flatten_with_paths(params)}
        state = TrainState(unflatten(params, p), adamw_init(unflatten(params, p), opt),
                           torch.zeros((), dtype=torch.int32))
        new, metrics = make_train_step(cfg, opt)(state, batch)
        return flatten_with_paths(new.params), metrics

    stepped, metrics = step()
    monkeypatch.setattr(tr, "checkpoint", _direct)
    loss_d, grads_d = _gradients(cfg, params, batch)
    stepped_d, metrics_d = step()
    assert torch.isfinite(loss) and torch.equal(loss, loss_d)
    assert all(torch.equal(g, h) for g, h in zip(grads, grads_d))
    assert any(bool((g != 0).any()) for g in grads)
    assert all(torch.equal(a, b) for (_k, a), (_j, b) in zip(stepped, stepped_d))
    assert torch.equal(metrics["grad_norm"], metrics_d["grad_norm"])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_serving_runs_the_bodies_without_a_checkpoint(family, monkeypatch):
    cfg = _config(family)
    params, batch = _params(cfg), _batch(cfg)
    batch.pop("labels")
    names = []
    monkeypatch.setattr(tr, "checkpoint", _recording(names))
    cache = serve.init_cache(cfg, B, S + 8, device="cpu")  # vlm: 4 patches ahead
    logits, cache = serve.prefill(params, cfg, batch, cache, device="cpu")
    serve.decode_step(params, cfg, logits.argmax(-1), cache, device="cpu")
    with torch.no_grad():
        tr.forward(params, cfg, batch)
    assert names == []


class _Saved:
    """Storage bytes autograd packs (each storage once), the parameters'
    left out."""

    def __init__(self, params):
        self.skip = {p.untyped_storage().data_ptr() for p in params}
        self.bytes: dict[int, int] = {}
        self.keep = []

    def pack(self, t):
        st = t.untyped_storage()
        if st.data_ptr() not in self.skip:
            self.bytes[st.data_ptr()] = st.nbytes()
            self.keep.append(t)
        return t

    def hooks(self):
        return torch.autograd.graph.saved_tensors_hooks(self.pack, lambda t: t)

    @property
    def total(self) -> int:
        return sum(self.bytes.values())


@pytest.mark.parametrize("family", list(FAMILIES))
def test_saved_bytes_fall_to_the_layer_inputs_and_what_runs_outside(family, monkeypatch):
    cfg = _config(family)
    params, batch = _params(cfg), _batch(cfg)

    def forward_saving(ckpt):
        monkeypatch.setattr(tr, "checkpoint", ckpt)
        tree, leaves = _leaves(params)
        outside = _Saved(leaves)
        with outside.hooks():
            total, _ = tr.loss_fn(tree, cfg, batch)
        torch.autograd.grad(total, leaves)
        return outside, leaves

    inside, inputs = [], []

    def direct_counting(fn, *args, **_kw):
        """The body called directly, what it saves counted apart, and its
        tensor inputs (the parameters' slices left out) recorded."""
        inputs.append([a for a in args if isinstance(a, torch.Tensor)])
        saved = _Saved([])
        inside.append(saved)
        with saved.hooks():
            return fn(*args)

    outside_d, leaves_d = forward_saving(direct_counting)
    skip = {p.untyped_storage().data_ptr() for p in leaves_d}
    body_inputs = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                   for ts in inputs for t in ts if t.untyped_storage().data_ptr() not in skip}
    inside_bytes = sum(s.total - sum(b for p, b in s.bytes.items() if p in skip)
                       for s in inside)
    remat, _ = forward_saving(real_checkpoint)
    outside, inp = outside_d.total, sum(body_inputs.values())
    print(f"\n{family}: direct saves {outside} outside + {inside_bytes} in the bodies; "
          f"remat saves {remat.total} (bodies' inputs {inp})")
    assert len(inside) == len(BODIES[family]) and inside_bytes > 0
    assert outside <= remat.total <= outside + inp
    assert remat.total < outside + inside_bytes


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "kimi-k2-1t-a32b"])
def test_routing_is_recorded_once_per_moe_layer_under_autograd(arch):
    cfg = dataclasses.replace(get_config(arch, "smoke"), n_layers=2, dtype=torch.float32)
    params, batch = _params(cfg), _batch(cfg)
    with torch.no_grad():
        want = []
        tr.forward(params, cfg, batch, routing=want)
    tree, leaves = _leaves(params)
    routing = []
    logits, aux = tr.forward(tree, cfg, batch, routing=routing)
    assert len(routing) == cfg.n_layers
    held = [dict(r) for r in routing]
    torch.autograd.grad(logits.square().mean() + aux, leaves)
    assert len(routing) == cfg.n_layers == len(want)
    for got, kept, ref in zip(routing, held, want):
        assert set(got) == {"experts", "kept", "margin"}
        assert all(got[k] is kept[k] for k in got)  # the recompute left the record alone
        assert all(torch.equal(got[k], ref[k]) for k in got)
