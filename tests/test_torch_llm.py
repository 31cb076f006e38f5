"""The port's dense serving path against the JAX package.

On the ``llama3.2-1b`` smoke config (2 layers, d_model 64, 4 / 2 heads),
with the JAX parameters carried across by ``model_params_from_reference``,
the port's ``prefill`` / ``decode_step`` logits and caches are held
against ``repro.models.serve``: to 1e-4 in float32 (the same math, summed
in another order) and in bf16 at ``tests/test_arch_smoke.py``'s
tolerances (2e-2 prefill, 5e-2 decode).  bf16 differs by bf16 rounding:
the JAX model rounds its attention logits and its SwiGLU gate to bf16,
the port's kernels keep them in float32 (ROADMAP Queue 3).  The port's
prefill + decode also reproduce its own teacher-forced ``forward``;
parameter shapes and counts equal the reference's at full width; the
``ServingModel`` plans equal the reference's.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import forward as jax_forward, init_params as jax_init_params, serve as jserve
from repro.serving.pipeline import ServingModel as JaxServingModel, StageRates as JaxStageRates
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import model_params_from_reference
from repro_torch.kernels import LAUNCHES
from repro_torch.models import serve
from repro_torch.models.transformer import forward, init_params, param_shapes
from repro_torch.serving.pipeline import ServingModel, StageRates

ARCH = "llama3.2-1b"
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _configs(dtype):
    jd, td = DTYPES[dtype]
    return (dataclasses.replace(jax_get_config(ARCH, "smoke"), dtype=jd),
            dataclasses.replace(get_config(ARCH, "smoke"), dtype=td))


def _models(dtype, seed=2):
    jcfg, tcfg = _configs(dtype)
    jparams, _ = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = model_params_from_reference(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def test_params_carry_over_bit_for_bit():
    jcfg, jparams, tcfg, tparams = _models("bfloat16")
    assert set(tparams) == set(jparams) and set(tparams["layers"]) == set(jparams["layers"])
    for name, w in tparams["layers"].items():
        assert w.dtype == torch.bfloat16
        np.testing.assert_array_equal(_f32(w), _f32(jparams["layers"][name]))
    np.testing.assert_array_equal(_f32(tparams["embed"]), _f32(jparams["embed"]))


@pytest.mark.parametrize("dtype,tol_pre,tol_dec",
                         [("float32", 1e-4, 1e-4), ("bfloat16", 2e-2, 5e-2)])
def test_prefill_and_decode_match_jax_serve(dtype, tol_pre, tol_dec):
    """Logits at tol_pre after the prefill and tol_dec per decode step; the
    caches at tol_dec throughout (in bf16 the second layer's keys inherit
    the first layer's rounding differences: the JAX model rounds its
    attention logits to bf16 before the softmax)."""
    jcfg, jparams, tcfg, tparams = _models(dtype)
    b, s, s_max = 2, 8, 32
    tokens = _tokens(tcfg, b, s, seed=2)
    jcache = jserve.init_cache(jcfg, b, s_max)
    jlogits, jcache = jserve.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)}, jcache)
    cache = serve.init_cache(tcfg, b, s_max, device="cpu")
    logits, cache = serve.prefill(tparams, tcfg, {"tokens": tokens}, cache, device="cpu")
    assert logits.shape == (b, tcfg.vocab) and logits.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(_f32(logits), _f32(jlogits), rtol=tol_pre, atol=tol_pre)
    for key in ("k", "v"):
        np.testing.assert_allclose(_f32(cache[key]), _f32(jcache[key]), rtol=tol_dec,
                                   atol=tol_dec)
    assert int(cache["length"]) == int(jcache["length"]) == s
    for _ in range(3):
        tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)  # both take JAX's
        jlogits, jcache = jserve.decode_step(jparams, jcfg, jnp.asarray(tok), jcache)
        logits, cache = serve.decode_step(tparams, tcfg, tok, cache, device="cpu")
        np.testing.assert_allclose(_f32(logits), _f32(jlogits), rtol=tol_dec, atol=tol_dec)
    for key in ("k", "v"):
        np.testing.assert_allclose(_f32(cache[key]), _f32(jcache[key]), rtol=tol_dec,
                                   atol=tol_dec)
    assert int(cache["length"]) == int(jcache["length"]) == s + 3
    assert cache["length"].dtype == torch.int32 and cache["length"].ndim == 0


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_forward_matches_jax_forward(dtype, tol):
    jcfg, jparams, tcfg, tparams = _models(dtype, seed=5)
    tokens = _tokens(tcfg, 2, 16, seed=5)
    jlogits, _ = jax_forward(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    logits, aux = forward(tparams, tcfg, {"tokens": torch.from_numpy(tokens)})
    assert logits.shape == (2, 16, tcfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(_f32(logits), _f32(jlogits), rtol=tol, atol=tol)


def test_logit_softcap_in_forward_only_as_in_jax():
    """``forward`` soft-caps its logits and ``serve`` does not, in both
    packages."""
    jcfg, jparams, tcfg, tparams = _models("float32", seed=6)
    jcfg = dataclasses.replace(jcfg, logit_softcap=0.05)
    tcfg = dataclasses.replace(tcfg, logit_softcap=0.05)
    tokens = _tokens(tcfg, 2, 8, seed=6)
    jlogits, _ = jax_forward(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    logits, _ = forward(tparams, tcfg, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(_f32(logits), _f32(jlogits), rtol=1e-4, atol=1e-4)
    jpre, _ = jserve.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)},
                             jserve.init_cache(jcfg, 2, 16))
    pre, _ = serve.prefill(tparams, tcfg, {"tokens": tokens}, serve.init_cache(tcfg, 2, 16,
                                                                                device="cpu"),
                           device="cpu")
    np.testing.assert_allclose(_f32(pre), _f32(jpre), rtol=1e-4, atol=1e-4)
    assert float(logits.abs().max()) <= 0.05 + 1e-6 < float(pre.abs().max())


@pytest.mark.parametrize("dtype,tol_pre,tol_dec",
                         [("float32", 1e-4, 1e-4), ("bfloat16", 2e-2, 5e-2)])
def test_decode_matches_forward_teacher_forcing(dtype, tol_pre, tol_dec):
    _, tcfg = _configs(dtype)
    params = init_params(tcfg, seed=3, device="cpu")
    tokens = torch.from_numpy(_tokens(tcfg, 1, 8, seed=4))
    full, _ = forward(params, tcfg, {"tokens": tokens})
    cache = serve.init_cache(tcfg, 1, 16, device="cpu")
    pre, cache = serve.prefill(params, tcfg, {"tokens": tokens[:, :4]}, cache, device="cpu")
    np.testing.assert_allclose(_f32(pre), _f32(full[:, 3]), rtol=tol_pre, atol=tol_pre)
    for t in range(4, 8):
        logits, cache = serve.decode_step(params, tcfg, tokens[:, t], cache, device="cpu")
        np.testing.assert_allclose(_f32(logits), _f32(full[:, t]), rtol=tol_dec, atol=tol_dec)
    assert int(cache["length"]) == 8


def test_cpu_serving_path_never_launches_a_kernel():
    _, tcfg = _configs("float32")
    params = init_params(tcfg, seed=0, device="cpu")
    before = dict(LAUNCHES)
    cache = serve.init_cache(tcfg, 2, 12, device="cpu")
    logits, cache = serve.prefill(params, tcfg, {"tokens": np.zeros((2, 5), np.int32)}, cache,
                                  device="cpu")
    serve.decode_step(params, tcfg, logits.argmax(-1), cache, device="cpu")
    assert dict(LAUNCHES) == before


def test_full_width_param_shapes_and_count_match_jax_without_allocating():
    jcfg = jax_get_config(ARCH, "full")
    tcfg = get_config(ARCH, "full")
    want = jax.eval_shape(lambda k: jax_init_params(jcfg, k)[0], jax.random.PRNGKey(0))
    shapes = param_shapes(tcfg)
    got = {k: v[0] for k, v in shapes.items() if k != "layers"}
    got["layers"] = {k: v[0] for k, v in shapes["layers"].items()}
    assert got == jax.tree.map(lambda a: tuple(a.shape), want)
    assert tcfg.params_count() == jcfg.params_count()
    n = sum(int(np.prod(s)) for s in jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, tuple)))
    norms = tcfg.d_model * (1 + 2 * tcfg.n_layers)  # not counted by params_count
    assert n == tcfg.params_count() + norms
    assert tcfg.dtype == torch.bfloat16 and tcfg.head_dim_ == 64 and tcfg.kv_dim == 512


def test_init_params_distributions():
    _, tcfg = _configs("float32")
    params = init_params(tcfg, seed=1, device="cpu")
    again = init_params(tcfg, seed=1, device="cpu")
    assert torch.equal(params["layers"]["wq"], again["layers"]["wq"])
    assert torch.all(params["layers"]["attn_norm"] == 1) and torch.all(params["final_norm"] == 1)
    assert abs(float(params["embed"].std()) - 0.02) < 0.002
    wi = params["layers"]["wi_gate"]
    assert abs(float(wi.std()) - tcfg.d_model ** -0.5) < 0.1 * tcfg.d_model ** -0.5


def test_unported_archs_raise_not_implemented():
    """Every architecture of the reference is ported: each one's configs
    load, and an arch the reference does not have raises ``KeyError``."""
    for arch in ARCHS:
        assert get_config(arch, "smoke").arch == arch + "-smoke"
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("whisper-large", "smoke")


def test_non_dense_families_raise():
    """A family the port does not know raises before anything is built."""
    cfg = dataclasses.replace(get_config(ARCH, "smoke"), family="diffusion")
    with pytest.raises(NotImplementedError, match="dense"):
        serve.init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="dense"):
        init_params(cfg, device="cpu")


@pytest.mark.parametrize("rates,lam0,kw", [
    ((0.5, 40.0), 4.0, dict(k_max=24)),
    ((1.3, 900.0), 4.0, dict(k_max=24)),
    ((0.8, 120.0), 2.5, dict(t_max=30.0)),
])
def test_serving_model_plans_match_jax(rates, lam0, kw):
    jm = JaxServingModel(JaxStageRates(*rates), mean_output_tokens=64)
    tm = ServingModel(StageRates(*rates), mean_output_tokens=64)
    ja, ta = jm.plan(lam0, **kw), tm.plan(lam0, **kw)
    assert tm.split(ta) == jm.split(ja)
    np.testing.assert_array_equal(ta.k, ja.k)
    np.testing.assert_allclose(ta.expected_sojourn, ja.expected_sojourn, rtol=1e-12)
    split = tm.split(ta)
    np.testing.assert_allclose(tm.expected_latency(lam0, split),
                               jm.expected_latency(lam0, split), rtol=1e-12)
    assert tm.names == jm.names == ["tokenize", "prefill", "decode", "detokenize"]
