"""The port's ssm (rwkv6) and hybrid (zamba2) serving paths against the JAX
package.

On both smoke configs, with the JAX parameters carried across by
``model_params_from_reference``, the port's ``prefill`` / ``decode_step``
logits and caches are held against ``repro.models.serve`` and its
``forward`` against the JAX ``forward``: to 1e-4 in float32 (the same
math, summed in another order) and in bf16 at ``tests/test_arch_smoke.py``'s
tolerances (2e-2 prefill, 5e-2 decode) scaled by the largest |value| in
each row.  The scaling is XLA's: the port's bf16 layers equal the JAX
layer functions run op by op bit for bit (tested below), but the JAX
serving path runs them inside a compiled ``lax.scan``, whose fusions keep
some bf16 intermediates in float32, so up to 3 of 4 logits differ in the
last bf16 bits (|d| up to 0.07 at |logit| ~3.5).  zamba2's chunked
prefill at S = 64 and 128 is held against the JAX token-by-token decode
loop instead: the JAX chunked
prefill is not finite there (its ``e^{-pc}`` overflows once a chunk's
log-decay passes -88; pinned below), the step recurrence is.  Parameter
shapes and counts at full width equal the JAX package's for both.
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
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_reference
from repro_torch.kernels import LAUNCHES
from repro_torch.models import serve
from repro_torch.models.transformer import forward, init_params, param_shapes

ARCHS = ("rwkv6-1.6b", "zamba2-7b")
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


def _state_keys(arch):
    return ("wkv", "tm_shift", "cm_shift") if arch == "rwkv6-1.6b" else ("ssm", "k", "v")


@pytest.mark.parametrize("arch", ARCHS)
def test_params_carry_over_bit_for_bit(arch):
    jcfg, jparams, tcfg, tparams = _models(arch, "bfloat16")
    assert set(tparams) == set(jparams)
    for group in ("layers", "shared_attn"):
        if group not in jparams:
            continue
        assert set(tparams[group]) == set(jparams[group])
        for name, w in tparams[group].items():
            assert w.dtype == torch.bfloat16
            np.testing.assert_array_equal(_f32(w), _f32(jparams[group][name]))


@pytest.mark.parametrize("dtype,tol_pre,tol_dec",
                         [("float32", 1e-4, 1e-4), ("bfloat16", 2e-2, 5e-2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax_serve(arch, dtype, tol_pre, tol_dec):
    """Logits at tol_pre after the prefill and tol_dec per decode step; the
    caches (states, shifts, keys and values) at tol_dec throughout."""
    jcfg, jparams, tcfg, tparams = _models(arch, dtype)
    b, s, s_max = 2, 8, 32
    tokens = _tokens(tcfg, b, s, seed=2)
    jcache = jserve.init_cache(jcfg, b, s_max)
    jlogits, jcache = jserve.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)}, jcache)
    cache = serve.init_cache(tcfg, b, s_max, device="cpu")
    logits, cache = serve.prefill(tparams, tcfg, {"tokens": tokens}, cache, device="cpu")
    assert logits.shape == (b, tcfg.vocab) and logits.dtype == DTYPES[dtype][1]
    _assert_close(logits, jlogits, tol_pre, dtype)
    for key in _state_keys(arch):
        _assert_close(cache[key], jcache[key], tol_dec, dtype)
    assert int(cache["length"]) == int(jcache["length"]) == s
    for _ in range(3):
        tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)  # both take JAX's
        jlogits, jcache = jserve.decode_step(jparams, jcfg, jnp.asarray(tok), jcache)
        logits, cache = serve.decode_step(tparams, tcfg, tok, cache, device="cpu")
        _assert_close(logits, jlogits, tol_dec, dtype)
    for key in _state_keys(arch):
        _assert_close(cache[key], jcache[key], tol_dec, dtype)
    assert int(cache["length"]) == int(jcache["length"]) == s + 3
    assert cache["length"].dtype == torch.int32 and cache["length"].ndim == 0


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax_forward(arch, dtype, tol):
    jcfg, jparams, tcfg, tparams = _models(arch, dtype, seed=5)
    tokens = _tokens(tcfg, 2, 16, seed=5)
    jlogits, _ = jax_forward(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    logits, aux = forward(tparams, tcfg, {"tokens": torch.from_numpy(tokens)})
    assert logits.shape == (2, 16, tcfg.vocab) and float(aux) == 0.0
    _assert_close(logits, jlogits, tol, dtype)


def test_bf16_layers_equal_the_jax_layer_functions_bit_for_bit():
    """RWKV6 time-mix and channel-mix, the Mamba2 mixer, and a two-layer
    RWKV stack built from the JAX layer functions called one by one, in
    bf16 on the same inputs: the port's outputs are bitwise equal (the
    float32 scan states to 1e-6)."""
    from repro.models import transformer as jt
    from repro_torch.models import transformer as tt

    x = np.random.default_rng(0).standard_normal((2, 8, 64)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    jz, tz = jnp.zeros((2, 64), jnp.bfloat16), torch.zeros((2, 64), dtype=torch.bfloat16)
    jcfg, jparams, tcfg, tparams = _models("rwkv6-1.6b", "bfloat16")
    jlp, tlp = jax.tree.map(lambda t: t[0], jparams["layers"]), tt.layer_params(tparams, 0)
    jo, _, jst = jt._rwkv_time_mix(jlp, jx, jz, jcfg, jnp.zeros((2, 4, 16, 16), jnp.float32))
    to, _, tst = tt._rwkv_time_mix(tlp, tx, tz, tcfg)
    np.testing.assert_array_equal(_f32(to), _f32(jo))
    np.testing.assert_allclose(_f32(tst), _f32(jst), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(_f32(tt._rwkv_channel_mix(tlp, tx, tz)[0]),
                                  _f32(jt._rwkv_channel_mix(jlp, jx, jz)[0]))
    h = jx
    for i in range(jcfg.n_layers):
        lp = jax.tree.map(lambda t, i=i: t[i], jparams["layers"])
        o, _, _ = jt._rwkv_time_mix(lp, jt.rms_norm(h, lp["tm_norm"], jcfg.norm_eps), jz, jcfg,
                                    jnp.zeros((2, 4, 16, 16), jnp.float32))
        h = h + o
        h = h + jt._rwkv_channel_mix(lp, jt.rms_norm(h, lp["cm_norm"], jcfg.norm_eps), jz)[0]
    np.testing.assert_array_equal(_f32(tt._rwkv_layers(tparams, tx, tcfg)), _f32(h))
    jcfg, jparams, tcfg, tparams = _models("zamba2-7b", "bfloat16")
    jlp, tlp = jax.tree.map(lambda t: t[0], jparams["layers"]), tt.layer_params(tparams, 0)
    jo, jst = jt._mamba2_mixer(jlp, jx, jcfg)
    to, tst = tt._mamba2_mixer(tlp, tx, tcfg)
    np.testing.assert_array_equal(_f32(to), _f32(jo))
    np.testing.assert_allclose(_f32(tst), _f32(jst), rtol=1e-6, atol=1e-6)


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
    np.testing.assert_allclose(_f32(pre), _f32(full[:, 3]), rtol=tol_pre, atol=tol_pre)
    for t in range(4, 8):
        logits, cache = serve.decode_step(params, tcfg, tokens[:, t], cache, device="cpu")
        np.testing.assert_allclose(_f32(logits), _f32(full[:, t]), rtol=tol_dec, atol=tol_dec)
    assert int(cache["length"]) == 8


@pytest.mark.parametrize("s", [64, 128])
def test_zamba2_prefill_matches_the_jax_decode_loop(s):
    """At S >= 64 the JAX chunked prefill is not finite; its token-by-token
    decode loop (the ``ssd_step`` recurrence) is, and the port's chunked
    prefill -- logits and every cached state, key and value -- equals it
    to 1e-4 in float32.  Two more decode steps from both caches agree."""
    jcfg, jparams, tcfg, tparams = _models("zamba2-7b", "float32", seed=0)
    tokens = _tokens(tcfg, 1, s, seed=0)
    jstep = jax.jit(lambda p, t, c: jserve.decode_step(p, jcfg, t, c))
    jcache = jserve.init_cache(jcfg, 1, s + 2)
    for t in range(s):
        jlogits, jcache = jstep(jparams, jnp.asarray(tokens[:, t]), jcache)
    cache = serve.init_cache(tcfg, 1, s + 2, device="cpu")
    logits, cache = serve.prefill(tparams, tcfg, {"tokens": tokens}, cache, device="cpu")
    assert bool(torch.isfinite(logits).all())
    np.testing.assert_allclose(_f32(logits), _f32(jlogits), rtol=1e-4, atol=1e-4)
    for key in ("ssm", "k", "v"):
        np.testing.assert_allclose(_f32(cache[key]), _f32(jcache[key]), rtol=1e-4, atol=1e-4)
    for _ in range(2):
        tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)
        jlogits, jcache = jstep(jparams, jnp.asarray(tok), jcache)
        logits, cache = serve.decode_step(tparams, tcfg, tok, cache, device="cpu")
        np.testing.assert_allclose(_f32(logits), _f32(jlogits), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch,s", [("rwkv6-1.6b", 37), ("zamba2-7b", 67)])
def test_prefill_of_a_prime_length_matches_jax(arch, s):
    """A prompt length the chunk does not divide: the port scans in full
    chunks (32 / 64) and one short last chunk, the JAX package in chunks of
    1 (its largest divisor of a prime S).  Logits and cached states agree to
    1e-4 in float32, as at any other length."""
    jcfg, jparams, tcfg, tparams = _models(arch, "float32", seed=0)
    tokens = _tokens(tcfg, 1, s, seed=4)
    jlogits, jcache = jserve.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)},
                                     jserve.init_cache(jcfg, 1, s))
    logits, cache = serve.prefill(tparams, tcfg, {"tokens": tokens},
                                  serve.init_cache(tcfg, 1, s, device="cpu"), device="cpu")
    assert bool(jnp.isfinite(jlogits).all())
    _assert_close(logits, jlogits, 1e-4, "float32")
    for key in _state_keys(arch):
        _assert_close(cache[key], jcache[key], 1e-4, "float32")


def test_jax_zamba2_prefill_is_not_finite_at_64_tokens_and_the_port_is():
    """The JAX package's own init (a_log ~ U(-1, 1), dt = softplus(.))
    sums one 64-token chunk's log-decay past -88 on seed 0: its chunked
    prefill returns NaN logits; the port's does not."""
    jcfg, jparams, tcfg, tparams = _models("zamba2-7b", "float32", seed=0)
    tokens = _tokens(tcfg, 1, 64, seed=0)
    jlogits, _ = jserve.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)},
                                jserve.init_cache(jcfg, 1, 64))
    assert not bool(jnp.isfinite(jlogits).all())
    logits, _ = serve.prefill(tparams, tcfg, {"tokens": tokens},
                              serve.init_cache(tcfg, 1, 64, device="cpu"), device="cpu")
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_cpu_serving_path_never_launches_a_kernel(arch):
    _, tcfg = _configs(arch, "float32")
    params = init_params(tcfg, seed=0, device="cpu")
    before = dict(LAUNCHES)
    cache = serve.init_cache(tcfg, 2, 12, device="cpu")
    logits, cache = serve.prefill(params, tcfg, {"tokens": np.zeros((2, 5), np.int32)}, cache,
                                  device="cpu")
    serve.decode_step(params, tcfg, logits.argmax(-1), cache, device="cpu")
    assert dict(LAUNCHES) == before


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_param_shapes_and_count_match_jax_without_allocating(arch):
    jcfg = jax_get_config(arch, "full")
    tcfg = get_config(arch, "full")
    want = jax.eval_shape(lambda k: jax_init_params(jcfg, k)[0], jax.random.PRNGKey(0))

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else v[0] for k, v in tree.items()}

    got = shapes(param_shapes(tcfg))
    assert got == jax.tree.map(lambda a: tuple(a.shape), want)
    assert tcfg.params_count() == jcfg.params_count()
    assert tcfg.dtype == torch.bfloat16
    if arch == "zamba2-7b":
        assert tcfg.head_dim_ == 112 and tcfg.n_kv_heads == tcfg.n_heads == 32
        assert len(serve.shared_sites(tcfg)) == 14
    else:
        assert tcfg.d_model // tcfg.n_heads == 64


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_distributions(arch):
    _, tcfg = _configs(arch, "float32")
    params = init_params(tcfg, seed=1, device="cpu")
    again = init_params(tcfg, seed=1, device="cpu")
    specs = param_shapes(tcfg)
    for group in [k for k in specs if isinstance(specs[k], dict)]:
        for name, (shape, init, scale) in specs[group].items():
            w = params[group][name]
            assert tuple(w.shape) == shape and torch.equal(w, again[group][name])
            if init == "ones":
                assert torch.all(w == 1)
            elif init == "zeros":
                assert torch.all(w == 0)
            elif init == "uniform":
                assert float(w.abs().max()) <= scale and float(w.abs().max()) > 0.5 * scale
    assert abs(float(params["embed"].std()) - 0.02) < 0.002


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_layouts_match_jax(arch):
    jcfg, tcfg = _configs(arch, "bfloat16")
    jcache = jserve.init_cache(jcfg, 3, 20)
    cache = serve.init_cache(tcfg, 3, 20, device="cpu")
    assert set(cache) == set(jcache)
    for key, want in jcache.items():
        assert tuple(cache[key].shape) == tuple(want.shape), key
        assert _f32(cache[key]).dtype == np.float32 and not _f32(cache[key]).any()
        assert str(cache[key].dtype).replace("torch.", "") == str(want.dtype), key
