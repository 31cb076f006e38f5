"""The moe family -- ``models/ffn.py``'s ``router_top_k`` / ``moe_layer``,
mixtral-8x22b and kimi-k2-1t-a32b -- on the port against the JAX package,
on the CPU.

The layer: seeded numpy inputs through both packages' ``moe_layer``; the
routing (experts, and which (token, slot) pairs were kept) exactly equal
to the JAX layer's (its kept set recomputed from its own formula,
``ffn.py:84-92``), the output and aux within 1e-5 in float32, and within
2e-2 of the row's largest |value| in bf16 (the bf16 router logits come
from one bf16 product on each side and route alike here), in the no-drop
regime (capacity 8.0) and in a drop regime (a router biased toward expert
0 at capacity 1.25, where most of expert 0's pairs drop); the B = 1 and B
= 4 decode steps' capacity of one slot per expert; float32 gradients of
every leaf and of x within 1e-5 of ``jax.grad``'s largest |value|.  The
bias keeps each token's top-2 gates a few units apart: a router whose two
gates lie ~20 apart saturates the softmax, and its gradient, a difference
of 1 and a weight within float32's resolution of 1, then rounds to a few
per cent differently in the two packages (seen at 1.6e-3 of the largest
router gradient, the same in float64 activations, whose router runs in
float32 in both).  The
combine sums a token's ``k`` results in slot order; for top-2 the order
cannot change the sum, for kimi-k2's top-8 in bf16 it can differ from
XLA's scatter order by rounding (not reached at the smoke configs' top-2).

Of equal router logits both packages take the lower expert (the port
sorts stably; logits rounded from bf16 tie often).  In bf16 the two
packages' hidden states differ by bf16 rounding, so a token whose k-th
and (k+1)-th router logits lie within ``_torch_archs.ROUTE_GAP`` (2^-5)
can take another expert, and its logits then differ by O(1): the bf16
model comparisons skip such tokens (the port's own routing margins say
which) and require at least half to be compared; float32 compares all.

The two archs' smoke configs as ``tests/test_torch_dense_archs.py`` holds
its archs (parameters bit for bit; forward, prefill / decode against
``repro.models.serve``, teacher forcing, one-step gradients of ``loss_fn``
with the aux term; full-width shapes and counts on the meta device).
kimi's smoke config runs at the reference's capacity 1.25, which drops
pairs in a 4-token prefill, so its teacher-forcing case runs at capacity
8.0 (drops make prefill + decode differ from one forward by design).
The serving comparison of kimi at capacity 1.25 keeps them: both packages
drop the same pairs.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_archs as A
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticTokens as JaxTokens
from repro.models import forward as jax_forward, init_params as jax_init_params, serve as jserve
from repro.models.ffn import moe_layer as jax_moe_layer, router_top_k as jax_router_top_k
from repro.models.transformer import loss_fn as jax_loss_fn
from repro.training import optimizer as jopt
from repro_torch.configs import for_kernels, get_config
from repro_torch.kernels.decode_attention.kernel import SHAPES as DECODE_SHAPES
from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS
from repro_torch.models import serve
from repro_torch.models.common import ModelConfig
from repro_torch.models.ffn import moe_capacity, moe_layer, router_top_k
from repro_torch.models.transformer import forward, init_params, loss_fn, param_shapes
from repro_torch.training.optimizer import global_norm

ARCHS = ("mixtral-8x22b", "kimi-k2-1t-a32b")
#: A layer at smoke width with mixtral's routing numbers (8 experts, top-2)
#: and kimi's shared expert.
LAYER = dict(arch="moe-test", family="moe", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2,
             d_ff=48, vocab=64, n_experts=8, top_k=2, n_shared_experts=1, moe_d_ff=48)


def _layer_cfgs(dtype, cf):
    jd, td = A.DTYPES[dtype]
    from repro.models.common import ModelConfig as JaxConfig

    return (JaxConfig(**LAYER, capacity_factor=cf, dtype=jd),
            ModelConfig(**LAYER, capacity_factor=cf, dtype=td))


def _layer_inputs(cfg, b, s, biased=False, seed=0):
    rng = np.random.default_rng(seed)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.expert_ff
    z = {"router": rng.normal(0, 0.3, (d, e)), "wi_gate": rng.normal(0, 0.2, (e, d, f)),
         "wi_up": rng.normal(0, 0.2, (e, d, f)), "wo": rng.normal(0, 0.2, (e, f, d)),
         "shared": {"wi_gate": rng.normal(0, 0.2, (d, f)), "wi_up": rng.normal(0, 0.2, (d, f)),
                    "wo": rng.normal(0, 0.2, (f, d))}}
    x = rng.normal(0, 1.0, (b, s, d))
    if biased:  # every token leans toward expert 0, its top-2 gates ~1-3 apart
        x += 0.5
        z["router"][:, 0] += 0.15
    return z, x


def _as(tree, fn):
    return {k: _as(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _jax_kept(experts, e, cap):
    """The JAX layer's kept (token, slot) pairs [T, k], by its own formula
    (``ffn.py:84-92``): stable argsort by expert, rank within the run."""
    flat = jnp.asarray(experts).reshape(-1)
    order = jnp.argsort(flat)
    se = flat[order]
    seg = jnp.searchsorted(se, jnp.arange(e), side="left")
    keep_sorted = (jnp.arange(flat.shape[0]) - seg[se]) < cap
    keep = np.zeros(flat.shape[0], bool)
    keep[np.asarray(order)] = np.asarray(keep_sorted)
    return keep.reshape(np.asarray(experts).shape)


def _run_layer(dtype, cf, b, s, biased=False, seed=0):
    jcfg, tcfg = _layer_cfgs(dtype, cf)
    z, x = _layer_inputs(tcfg, b, s, biased, seed)
    jd, td = A.DTYPES[dtype]
    jz = _as(z, lambda a: jnp.asarray(a, jd))
    tz = _as(z, lambda a: torch.from_numpy(a).to(td))
    jx, tx = jnp.asarray(x, jd), torch.from_numpy(x).to(td)
    jout, jaux = jax_moe_layer(jz, jx, jcfg)
    routing = {}
    out, aux = moe_layer(tz, tx, tcfg, routing)
    jlogits = (jx.reshape(-1, jcfg.d_model) @ jz["router"]).astype(jnp.float32)
    _w, jexperts = jax_router_top_k(jlogits, jcfg.top_k)
    cap = moe_capacity(tcfg, b * s)
    return dict(jout=jout, jaux=jaux, out=out, aux=aux, routing=routing,
                jexperts=np.asarray(jexperts), jkept=_jax_kept(jexperts, tcfg.n_experts, cap),
                cap=cap, jz=jz, tz=tz, jx=jx, tx=tx, jcfg=jcfg, tcfg=tcfg)


def test_router_top_k_matches_jax():
    logits = np.random.default_rng(1).normal(0, 1, (64, 384)).astype(np.float32)
    jw, je = jax_router_top_k(jnp.asarray(logits), 8)
    w, e = router_top_k(torch.from_numpy(logits), 8)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)
    assert w.dtype == torch.float32


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("regime", ["no-drop", "drop"])
def test_moe_layer_matches_jax(regime, dtype, tol):
    r = _run_layer(dtype, 8.0 if regime == "no-drop" else 1.25, 4, 16,
                   biased=regime == "drop")
    np.testing.assert_array_equal(r["routing"]["experts"].numpy(), r["jexperts"])
    kept = r["routing"]["kept"].numpy()
    np.testing.assert_array_equal(kept, r["jkept"])
    if regime == "no-drop":
        assert kept.all()
    else:  # many pairs past their expert's capacity, most of them expert 0's
        assert (~kept).sum() > 16 and (r["jexperts"][~kept] == 0).mean() > 0.5
    A.assert_close(r["out"], r["jout"], tol, dtype)
    assert float(r["aux"]) == pytest.approx(float(r["jaux"]), rel=1e-5)
    assert r["out"].dtype == A.DTYPES[dtype][1] and r["aux"].dtype == torch.float32


@pytest.mark.parametrize("b", [1, 4])
def test_decode_step_capacity_is_one_slot(b):
    """A decode step of B tokens at mixtral's routing (8 experts, top-2,
    capacity factor 1.25): ``max(1, int(1.25 * B * 2 / 8))`` = 1 slot per
    expert, so two tokens on one expert drop one pair -- as in JAX."""
    r = _run_layer("float32", 1.25, b, 1, seed=5 + b)
    assert r["cap"] == 1
    np.testing.assert_array_equal(r["routing"]["kept"].numpy(), r["jkept"])
    np.testing.assert_allclose(r["out"].numpy(), np.asarray(r["jout"]), rtol=1e-5, atol=1e-5)
    if b == 4:
        assert not r["jkept"].all()  # seed chosen so that a pair drops


@pytest.mark.parametrize("regime", ["no-drop", "drop"])
def test_moe_layer_gradients_equal_jax(regime):
    r = _run_layer("float32", 8.0 if regime == "no-drop" else 1.25, 2, 16,
                   biased=regime == "drop")
    tz = _as(r["tz"], lambda t: t.clone().requires_grad_())
    tx = r["tx"].clone().requires_grad_()
    out, aux = moe_layer(tz, tx, r["tcfg"])
    loss = (out ** 2).mean() + 0.01 * aux
    paths = A.leaves(tz)
    grads = torch.autograd.grad(loss, [t for _k, t in paths] + [tx])

    def jloss(p, x):
        o, a = jax_moe_layer(p, x, r["jcfg"])
        return (o ** 2).mean() + 0.01 * a

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(r["jz"], r["jx"])
    want = dict(A.leaves(jgp))
    for (key, _t), g in zip(paths, grads):
        w = np.asarray(want[key])
        assert np.abs(w).max() > 0, key
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max(),
                                   err_msg=key)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jgx)).max())


# ------------------------------------------------------------ the archs -- #
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_jax_configs(arch):
    for preset in ("full", "smoke"):
        want = dataclasses.asdict(jax_get_config(arch, preset))
        got = dataclasses.asdict(get_config(arch, preset))
        assert {k: v for k, v in got.items() if k != "dtype"} == {
            k: v for k, v in want.items() if k != "dtype"}
        assert got["dtype"] == torch.bfloat16 and want["dtype"] == jnp.bfloat16
    full = get_config(arch, "full")
    assert full.head_dim_ in HEAD_DIMS and for_kernels(full) is full
    assert (full.head_dim_, full.n_heads // full.n_kv_heads) in DECODE_SHAPES
    smoke = get_config(arch, "smoke")
    wide = for_kernels(smoke)  # a smoke run on the card
    assert (wide.head_dim_, wide.n_heads // wide.n_kv_heads) in DECODE_SHAPES
    assert wide.expert_ff == smoke.expert_ff * 4 and wide.n_experts == smoke.n_experts


@pytest.mark.parametrize("arch", ARCHS)
def test_params_carry_over_bit_for_bit(arch):
    _jcfg, jparams, tcfg, tparams = A.models(arch, "bfloat16")
    want = dict(A.leaves(jparams))
    got = A.leaves(tparams)
    assert {k for k, _ in got} == set(want)
    assert any(k.startswith("layers/shared/") for k, _ in got) == (tcfg.n_shared_experts > 0)
    for key, w in got:
        assert w.dtype == torch.bfloat16
        np.testing.assert_array_equal(A.f32(w), A.f32(want[key]), err_msg=key)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax_forward(arch, dtype, tol):
    """Logits of the tokens without a near tie (``A.near_ties``: none may be
    skipped in float32, at most half in bf16: kimi's smoke router, 8
    experts over logits of ~1, leaves a third of its tokens within
    ``A.ROUTE_GAP``) and the aux loss."""
    jcfg, jparams, tcfg, tparams = A.models(arch, dtype, seed=5)
    batch = A.batch(tcfg, 2, 16, seed=5)
    jlogits, jaux = jax_forward(jparams, jcfg, A.to_jax(batch, jcfg))
    routing = []
    logits, aux = forward(tparams, tcfg, A.to_torch(batch, tcfg), routing=routing)
    assert logits.shape == (2, 16, tcfg.vocab) and float(aux) > 0
    assert len(routing) == tcfg.n_layers
    ok = ~A.near_ties(routing, 2, dtype)
    assert ok.all() if dtype == "float32" else ok.mean() >= 0.5
    A.assert_close(logits, jlogits, tol, dtype, rows=ok)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-4 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("dtype,tol_pre,tol_dec",
                         [("float32", 1e-4, 1e-4), ("bfloat16", 2e-2, 5e-2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax_serve(arch, dtype, tol_pre, tol_dec):
    """Logits and cached keys and values of the tokens without a near tie
    (``A.near_ties``; for the prefill's logits its last token): none
    skipped in float32, at most half in bf16 (mixtral's second step routes
    one token 0.0015 from another expert)."""
    jcfg, jparams, tcfg, tparams = A.models(arch, dtype)
    b, s, s_max = 2, 8, 32
    tokens = A.batch(tcfg, b, s, seed=2)["tokens"]
    jcache = jserve.init_cache(jcfg, b, s_max)
    jlogits, jcache = jserve.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)}, jcache)
    cache = serve.init_cache(tcfg, b, s_max, device="cpu")
    routing = []
    logits, cache = serve.prefill(tparams, tcfg, {"tokens": tokens}, cache, device="cpu",
                                  routing=routing)
    ok = ~A.near_ties(routing, b, dtype)
    A.assert_close(logits, jlogits, tol_pre, dtype, rows=ok[:, -1])
    for _ in range(3):
        tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)  # both take JAX's
        jlogits, jcache = jserve.decode_step(jparams, jcfg, jnp.asarray(tok), jcache)
        routing = []
        logits, cache = serve.decode_step(tparams, tcfg, tok, cache, device="cpu",
                                          routing=routing)
        ok = np.concatenate([ok, ~A.near_ties(routing, b, dtype)], 1)
        A.assert_close(logits, jlogits, tol_dec, dtype, rows=ok[:, -1])
    assert ok.all() if dtype == "float32" else ok.mean() >= 0.5
    for key in ("k", "v"):
        assert cache[key].shape == jcache[key].shape
        got, want = A.f32(cache[key])[:, :, :s + 3], A.f32(jcache[key])[:, :, :s + 3]
        A.assert_close(got[:, ok], want[:, ok], tol_dec, dtype)
    assert int(cache["length"]) == int(jcache["length"]) == s + 3


@pytest.mark.parametrize("dtype,tol_pre,tol_dec",
                         [("float32", 1e-4, 1e-4), ("bfloat16", 2e-2, 5e-2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward_teacher_forcing(arch, dtype, tol_pre, tol_dec):
    _, tcfg = A.configs(arch, dtype, capacity_factor=8.0)
    params = init_params(tcfg, seed=3, device="cpu")
    tokens = torch.from_numpy(A.batch(tcfg, 1, 8, seed=4)["tokens"]).long()
    full, _ = forward(params, tcfg, {"tokens": tokens})
    cache = serve.init_cache(tcfg, 1, 16, device="cpu")
    pre, cache = serve.prefill(params, tcfg, {"tokens": tokens[:, :4]}, cache, device="cpu")
    A.assert_close(pre, full[:, 3], tol_pre, dtype)
    for t in range(4, 8):
        logits, cache = serve.decode_step(params, tcfg, tokens[:, t], cache, device="cpu")
        A.assert_close(logits, full[:, t], tol_dec, dtype)
    assert int(cache["length"]) == 8


@pytest.mark.parametrize("arch", ARCHS)
def test_one_step_gradients_equal_the_jax_gradients(arch):
    """Every leaf (the router, the experts and kimi's shared expert too)
    within rtol 1e-4 of its largest |gradient|, the aux term included
    (``loss_fn``'s 0.01 weight), and the global norms within 1e-5."""
    jcfg, jparams, tcfg, tparams = A.models(arch, "float32", seed=3)
    batch = next(JaxTokens(JaxDataConfig(vocab=jcfg.vocab, batch=2, seq_len=24, seed=3)))
    leaves = A.leaves(tparams)
    for _k, t in leaves:
        t.requires_grad_()
    total, metrics = loss_fn(tparams, tcfg,
                             {k: torch.from_numpy(v).long() for k, v in batch.items()})
    assert float(metrics["aux_loss"].detach()) > 0
    grads = torch.autograd.grad(total, [t for _k, t in leaves])
    jgrads = jax.grad(lambda p: jax_loss_fn(p, jcfg, jax.tree.map(jnp.asarray, batch))[0])(
        jparams)
    want = dict(A.leaves(jgrads))
    for (key, _t), g in zip(leaves, grads):
        w = np.asarray(want[key])
        assert np.abs(w).max() > 0, key
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=key)
    assert float(global_norm(dict(enumerate(grads)))) == pytest.approx(
        float(jopt.global_norm(jgrads)), rel=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_param_shapes_and_count_match_jax_without_allocating(arch):
    jcfg = jax_get_config(arch, "full")
    tcfg = get_config(arch, "full")
    want = jax.eval_shape(lambda k: jax_init_params(jcfg, k)[0], jax.random.PRNGKey(0))
    got = A.shapes_of(param_shapes(tcfg))
    assert got == jax.tree.map(lambda a: tuple(a.shape), want)
    assert tcfg.params_count() == jcfg.params_count()
    shapes = jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, tuple))
    n = sum(int(np.prod(s)) for s in shapes)
    norms = tcfg.d_model * (1 + 2 * tcfg.n_layers)  # not counted by params_count
    assert n == tcfg.params_count() + norms
    meta = [torch.empty(s, dtype=tcfg.dtype, device="meta") for s in shapes]
    assert sum(t.numel() for t in meta) == n  # ~141 B / ~1.04 T, none allocated


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loop_resumes_bit_for_bit(arch, tmp_path):
    """The smoke config through ``TrainLoop`` on the CPU (float32): 4 steps
    with finite losses, and a crash at 2 resumed to 4 equal
    to the straight run in every loss and final parameter."""
    _, tcfg = A.configs(arch, "float32")
    straight, resumed, differ = A.crash_and_resume(tcfg, tmp_path)
    assert len(straight) == 4 and all(np.isfinite(straight))
    assert resumed == straight and not differ


def test_init_params_draws_a_large_leaf_in_chunks(monkeypatch):
    """A leaf past ``DRAW_CHUNK`` elements (kimi-k2's expert stacks are 5.6
    B) is drawn in chunks of whole rows: the same shapes, the init's
    distribution, and the same numbers again from the same seed."""
    from repro_torch.models import transformer

    _, tcfg = A.configs("kimi-k2-1t-a32b", "float32")
    monkeypatch.setattr(transformer, "DRAW_CHUNK", 100)  # every matrix leaf chunked
    params = init_params(tcfg, seed=4, device="cpu")
    again = init_params(tcfg, seed=4, device="cpu")
    want = dict(A.leaves(A.shapes_of(param_shapes(tcfg)),
                         is_leaf=lambda x: isinstance(x, tuple)))
    assert {k: tuple(t.shape) for k, t in A.leaves(params)} == want
    for (k, x), (_k, y) in zip(A.leaves(params), A.leaves(again)):
        assert torch.equal(x, y), k
    wi = params["layers"]["moe_wi_gate"]  # [L, E, D, F], normal / sqrt(D)
    assert abs(float(wi.std()) - tcfg.d_model ** -0.5) < 0.05 * tcfg.d_model ** -0.5
    assert abs(float(params["embed"].std()) - 0.02) < 0.002
