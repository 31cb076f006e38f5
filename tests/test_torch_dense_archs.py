"""The dense family at head dim 128 -- phi3-medium-14b, yi-34b and
command-r-35b -- on the port against the JAX package, on the CPU.

Each arch's smoke config (phi3: 4 / 2 heads; yi: 7 heads over one KV
head; command-r: 8 over one, tied embeddings, a 512-token vocab), with the
JAX parameters carried across by ``model_params_from_reference``, is held
as ``tests/test_torch_llm.py`` holds llama: the parameters bit for bit;
``forward`` within 1e-4 in float32 and 2e-2 in bf16; ``prefill`` /
``decode_step`` logits and caches against ``repro.models.serve`` within
1e-4 in float32 and 2e-2 (prefill) / 5e-2 (decode) in bf16; the port's
prefill + decode against its own teacher-forced ``forward``; one-step
float32 gradients within rtol 1e-4 of each leaf's largest |gradient|;
at full width the configs, parameter shapes and counts equal the JAX
package's without allocating (head dim 128 in all three).  bf16 differs
by bf16 rounding: the JAX model rounds its attention logits and its SwiGLU
gate to bf16, the port keeps them in float32 (ROADMAP Queue 3).  So in
bf16 the limit is the tolerance times one plus the largest |value| in the
row, as ``tests/test_torch_ssm_models.py`` holds bf16: phi3's and yi's
untied heads give logits of ~1.5 (llama's tied embedding ~0.05), where a
few bf16 ulps of the row's scale land on logits near 0.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticTokens as JaxTokens
from repro.models import forward as jax_forward, init_params as jax_init_params, serve as jserve
from repro.models.transformer import loss_fn as jax_loss_fn
from repro.training import optimizer as jopt
from repro_torch.configs import for_kernels, get_config
from repro_torch.convert import model_params_from_reference
from repro_torch.kernels.decode_attention.kernel import SHAPES as DECODE_SHAPES
from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS
from repro_torch.models import serve
from repro_torch.models.transformer import forward, init_params, loss_fn, param_shapes
from repro_torch.training.optimizer import global_norm
from repro_torch.tree import flatten_with_paths as _leaves

ARCHS = ("phi3-medium-14b", "yi-34b", "command-r-35b")
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _configs(arch, dtype):
    jd, td = DTYPES[dtype]
    return (dataclasses.replace(jax_get_config(arch, "smoke"), dtype=jd),
            dataclasses.replace(get_config(arch, "smoke"), dtype=td))


def _models(arch, dtype, seed=2):
    jcfg, tcfg = _configs(arch, dtype)
    jparams, _ = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = model_params_from_reference(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_close(got, want, tol, dtype):
    """float32: |d| <= tol * (1 + |want|); bf16: |d| <= tol * (1 + the
    largest |want| in the last-axis row)."""
    got, want = _f32(got).astype(np.float64), _f32(want).astype(np.float64)
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        return
    limit = tol * (1 + np.abs(want).max(-1, keepdims=True))
    np.testing.assert_array_less(np.abs(got - want), np.broadcast_to(limit, want.shape))


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_jax_configs(arch):
    for preset in ("full", "smoke"):
        want = dataclasses.asdict(jax_get_config(arch, preset))
        got = dataclasses.asdict(get_config(arch, preset))
        assert set(got) == set(want)
        assert {k: v for k, v in got.items() if k != "dtype"} == {
            k: v for k, v in want.items() if k != "dtype"}
        assert got["dtype"] == torch.bfloat16 and want["dtype"] == jnp.bfloat16
    full = get_config(arch, "full")
    assert full.head_dim_ == 128 and full.head_dim_ in HEAD_DIMS and for_kernels(full) is full
    assert (128, full.n_heads // full.n_kv_heads) in DECODE_SHAPES
    wide = for_kernels(get_config(arch, "smoke"))  # a smoke run on the card
    assert (wide.head_dim_, wide.n_heads // wide.n_kv_heads) in DECODE_SHAPES


@pytest.mark.parametrize("arch", ARCHS)
def test_params_carry_over_bit_for_bit(arch):
    jcfg, jparams, tcfg, tparams = _models(arch, "bfloat16")
    assert set(tparams) == set(jparams) and set(tparams["layers"]) == set(jparams["layers"])
    assert ("lm_head" in tparams) == (not tcfg.tie_embeddings)
    for key, w in _leaves(tparams):
        assert w.dtype == torch.bfloat16
        np.testing.assert_array_equal(_f32(w), _f32(dict(_leaves(jparams))[key]), err_msg=key)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax_forward(arch, dtype, tol):
    jcfg, jparams, tcfg, tparams = _models(arch, dtype, seed=5)
    tokens = _tokens(tcfg, 2, 16, seed=5)
    jlogits, _ = jax_forward(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    logits, aux = forward(tparams, tcfg, {"tokens": torch.from_numpy(tokens)})
    assert logits.shape == (2, 16, tcfg.vocab) and float(aux) == 0.0
    _assert_close(logits, jlogits, tol, dtype)


@pytest.mark.parametrize("dtype,tol_pre,tol_dec",
                         [("float32", 1e-4, 1e-4), ("bfloat16", 2e-2, 5e-2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax_serve(arch, dtype, tol_pre, tol_dec):
    jcfg, jparams, tcfg, tparams = _models(arch, dtype)
    b, s, s_max = 2, 8, 32
    tokens = _tokens(tcfg, b, s, seed=2)
    jcache = jserve.init_cache(jcfg, b, s_max)
    jlogits, jcache = jserve.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)}, jcache)
    cache = serve.init_cache(tcfg, b, s_max, device="cpu")
    logits, cache = serve.prefill(tparams, tcfg, {"tokens": tokens}, cache, device="cpu")
    assert logits.shape == (b, tcfg.vocab) and logits.dtype == DTYPES[dtype][1]
    _assert_close(logits, jlogits, tol_pre, dtype)
    for _ in range(3):
        tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)  # both take JAX's
        jlogits, jcache = jserve.decode_step(jparams, jcfg, jnp.asarray(tok), jcache)
        logits, cache = serve.decode_step(tparams, tcfg, tok, cache, device="cpu")
        _assert_close(logits, jlogits, tol_dec, dtype)
    for key in ("k", "v"):
        assert cache[key].shape == jcache[key].shape
        _assert_close(cache[key], jcache[key], tol_dec, dtype)
    assert int(cache["length"]) == int(jcache["length"]) == s + 3


@pytest.mark.parametrize("dtype,tol_pre,tol_dec",
                         [("float32", 1e-4, 1e-4), ("bfloat16", 2e-2, 5e-2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward_teacher_forcing(arch, dtype, tol_pre, tol_dec):
    _, tcfg = _configs(arch, dtype)
    params = init_params(tcfg, seed=3, device="cpu")
    tokens = torch.from_numpy(_tokens(tcfg, 1, 8, seed=4))
    full, _ = forward(params, tcfg, {"tokens": tokens})
    cache = serve.init_cache(tcfg, 1, 16, device="cpu")
    pre, cache = serve.prefill(params, tcfg, {"tokens": tokens[:, :4]}, cache, device="cpu")
    _assert_close(pre, full[:, 3], tol_pre, dtype)
    for t in range(4, 8):
        logits, cache = serve.decode_step(params, tcfg, tokens[:, t], cache, device="cpu")
        _assert_close(logits, full[:, t], tol_dec, dtype)
    assert int(cache["length"]) == 8


@pytest.mark.parametrize("arch", ARCHS)
def test_one_step_gradients_equal_the_jax_gradients(arch):
    """Every leaf within rtol 1e-4 of its largest |gradient| and the global
    norms within 1e-5 (the rule of the llama test)."""
    jcfg, jparams, tcfg, tparams = _models(arch, "float32", seed=3)
    batch = next(JaxTokens(JaxDataConfig(vocab=jcfg.vocab, batch=2, seq_len=24, seed=3)))
    leaves = _leaves(tparams)
    for _k, t in leaves:
        t.requires_grad_()
    total, _ = loss_fn(tparams, tcfg, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    grads = torch.autograd.grad(total, [t for _k, t in leaves])
    jgrads = jax.grad(lambda p: jax_loss_fn(p, jcfg, jax.tree.map(jnp.asarray, batch))[0])(
        jparams)
    want = dict(_leaves(jgrads))
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
    shapes = param_shapes(tcfg)
    got = {k: v[0] for k, v in shapes.items() if k != "layers"}
    got["layers"] = {k: v[0] for k, v in shapes["layers"].items()}
    assert got == jax.tree.map(lambda a: tuple(a.shape), want)
    assert tcfg.params_count() == jcfg.params_count()
    n = sum(int(np.prod(s)) for s in jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, tuple)))
    norms = tcfg.d_model * (1 + 2 * tcfg.n_layers)  # not counted by params_count
    assert n == tcfg.params_count() + norms
    meta = [torch.empty(shape, dtype=tcfg.dtype, device="meta")
             for shape in jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, tuple))]
    assert sum(t.numel() for t in meta) == n  # ~14.7 B / 34.4 B / 30.3 B, none allocated
