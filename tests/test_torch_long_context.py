"""The ``long_500k`` shape (``configs/shapes.py``: one new token against a
cache of 524,288 rows, batch 1) on the port against the JAX package, on the
CPU, at the smoke configs with ``s_max`` = 524,288.

* Decode parity at the cache's end: tiny mixtral (window 8) and tiny
  zamba2 (two shared-attention sites) from seeded keys, values (and zamba2's
  SSM states) at length ``s_max - 4``: four steps to a full cache, then one
  step on it, logits and the written rows within the dense and SSM tests'
  tolerances (1e-4 in float32; bf16 at 5e-2 of the row's largest |value|),
  every other row untouched.  The JAX steps run under ``jax.jit`` with the
  cache donated, so neither package copies it.
* The full-cache write: the reference writes a step's key and value with
  ``dynamic_update_slice(row, k, (0, length, 0, 0))``, whose start XLA
  clamps to ``s_max - 1``, so on a full cache it overwrites the last row.
  The port clamps its write position the same way on the device
  (``models/serve.py:decode_step``; it raised ``IndexError`` from
  ``index_copy_`` there before).  For the decoder (llama, mixtral), hybrid
  (zamba2) and audio (whisper) caches at a small ``s_max``: the port's
  cache after the step equals, bit for bit, ``dynamic_update_slice`` of
  its cache before the step with its written row at start ``s_max``, as
  the JAX package's does with its own, and the two written rows agree.
* Tiny rwkv6: a 65,536-token prefill (the longest a CPU run of both
  packages takes in seconds; the card prefills 524,256), then decode
  steps; state and last logits within 1e-4.
* ``apply_rope`` at positions 524,224-524,287 against the JAX function and
  a float64 rotation of the same float32 angles.  Two things differ there,
  both pinned below.  The two packages' float32 frequency tables differ by
  one ulp in one entry at head dims 112 and 128 (XLA's and torch's float32
  ``pow`` round differently), which at position 524,287 moves that angle
  by up to ``pos * ulp``.  And XLA's CPU backend computes the float32
  ``cos`` / ``sin`` of a jitted RoPE far less exactly than ``jnp.cos`` run
  alone: off by 2.5e-3 (head dim 16) to 5.7e-2 (head dim 64) at position
  524,284, where the port and the eager JAX function are within 2e-7.  So
  the decode tests above give the jitted JAX step its RoPE's ``cos`` /
  ``sin`` of the same float32 angles from a float64 table
  (:func:`_exact_rope`); everything else in the step is the reference's.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_archs as A
from repro.models import serve as jserve
from repro.models.common import apply_rope as jax_apply_rope, rope_frequencies as jax_freqs
from repro_torch.models import serve
from repro_torch.models.common import apply_rope, rope_frequencies

S_MAX = 524_288  # long_500k's seq_len
TOL = {"float32": 1e-4, "bfloat16": 5e-2}  # the decode tolerances of the dense / SSM tests


#: The first position of :func:`_rope_table`.
TABLE_LO = S_MAX - 64


@functools.lru_cache(maxsize=None)
def _rope_table(dh: int, theta: float):
    """cos / sin [S_MAX + 1 - TABLE_LO, Dh / 2] of the reference's float32
    angles ``position * rope_frequencies(dh, theta)`` at positions
    ``TABLE_LO``-``S_MAX``, each rounded once from float64."""
    with jax.ensure_compile_time_eval():  # a constant, also when first asked inside a trace
        inv = np.asarray(jax_freqs(dh, theta))
    pos = np.arange(TABLE_LO, S_MAX + 1, dtype=np.float32)[:, None]
    angles = (pos * inv).astype(np.float64)
    return np.cos(angles).astype(np.float32), np.sin(angles).astype(np.float32)


def _exact_rope(x, positions, theta):
    """The reference's ``apply_rope`` with its ``cos`` / ``sin`` looked up
    (positions ``TABLE_LO``-``S_MAX``)."""
    cos, sin = _rope_table(x.shape[-1], float(theta))
    cos, sin = (jnp.asarray(t)[positions - TABLE_LO][:, :, None, :] for t in (cos, sin))
    x1, x2 = jnp.split(x.astype(jnp.float32), 2, axis=-1)
    return jnp.concatenate([x1 * cos - x2 * sin, x1 * sin + x2 * cos], axis=-1).astype(x.dtype)


def _jax_step(jcfg):
    """The JAX decode step with its cache donated (updated in place)."""
    return jax.jit(lambda p, t, c: jserve.decode_step(p, jcfg, t, c), donate_argnums=(2,))


def _seeded_caches(jcfg, tcfg, length, seed):
    """Both packages' caches of batch 1 and ``S_MAX`` rows, every K / V row
    (and zamba2's SSM state) drawn from one numpy seed in float32 and cast
    to the model's dtype (the same bits in both), at ``length``."""
    rng = np.random.default_rng(seed)
    cache = serve.init_cache(tcfg, 1, S_MAX, device="cpu")
    jcache = dict(jax.eval_shape(lambda: jserve.init_cache(jcfg, 1, S_MAX)))
    for key in ("k", "v", "ssm"):
        if key not in cache:
            continue
        x = rng.standard_normal(tuple(cache[key].shape), dtype=np.float32)
        if key == "ssm":
            x *= 0.5
        jcache[key] = jnp.asarray(x, jcache[key].dtype)
        cache[key] = torch.from_numpy(x).to(cache[key].dtype)
        del x
    jcache["length"] = jnp.int32(length)
    cache["length"] = torch.tensor(length, dtype=torch.int32)
    return jcache, cache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "zamba2-7b"])
def test_decode_to_and_past_a_full_cache_matches_jax(arch, dtype, monkeypatch):
    monkeypatch.setattr(jserve, "apply_rope", _exact_rope)
    jcfg, jparams, tcfg, tparams = A.models(arch, dtype, seed=4)
    jcache, cache = _seeded_caches(jcfg, tcfg, S_MAX - 4, seed=4)
    before = {k: A.f32(cache[k][:, :, S_MAX - 16:S_MAX - 4]).copy() for k in ("k", "v")}
    step = _jax_step(jcfg)
    tok = np.array([7], dtype=np.int32)
    routing_ok = []
    for i in range(5):  # lengths s_max - 4 ... s_max - 1, then the full cache
        jlogits, jcache = step(jparams, jnp.asarray(tok), jcache)
        routing = []
        logits, cache = serve.decode_step(tparams, tcfg, tok, cache, device="cpu",
                                          routing=routing)
        ok = not A.near_ties(routing, 1, dtype).any() if routing else True
        routing_ok.append(ok)
        if ok:
            A.assert_close(logits, jlogits, TOL[dtype], dtype)
        assert int(cache["length"]) == int(jcache["length"]) == S_MAX - 3 + i
        tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)  # both take JAX's
    assert all(routing_ok) if dtype == "float32" else sum(routing_ok) >= 3
    assert torch.isfinite(logits.float()).all()
    for key in ("k", "v"):
        got, want = A.f32(cache[key]), A.f32(jcache[key])
        assert got.shape == want.shape == (*cache[key].shape[:2], S_MAX, *got.shape[3:])
        # the last four rows written; the step on the full cache rewrote the last
        A.assert_close(got[:, :, S_MAX - 4:], want[:, :, S_MAX - 4:], TOL[dtype], dtype)
        np.testing.assert_array_equal(got[:, :, S_MAX - 16:S_MAX - 4], before[key])
        np.testing.assert_array_equal(got[:, :, :S_MAX - 4], want[:, :, :S_MAX - 4])
    if arch == "zamba2-7b":
        A.assert_close(cache["ssm"], jcache["ssm"], TOL[dtype], dtype)


#: (arch, the batch's prompt length): each family's cache at a small s_max.
FULL_WRITE = [("llama3.2-1b", 12), ("mixtral-8x22b", 12), ("zamba2-7b", 12),
              ("whisper-medium", 12)]


@pytest.mark.parametrize("arch,s_max", FULL_WRITE, ids=[a for a, _s in FULL_WRITE])
def test_a_step_on_a_full_cache_overwrites_its_last_row_as_dynamic_update_slice(arch, s_max):
    """Prefill ``s_max`` tokens (a full cache), then one step: in both
    packages every row but the last keeps its bits and the last holds the
    step's key and value -- exactly ``dynamic_update_slice`` at start
    ``s_max`` (clamped by XLA) of the cache before the step with that row;
    the two packages' rows and logits within 1e-4 (float32)."""
    jcfg, jparams, tcfg, tparams = A.models(arch, "float32", seed=6)
    prompt = A.batch(tcfg, 2, s_max, seed=6)
    jlogits, jcache = jserve.prefill(jparams, jcfg, A.to_jax(prompt, jcfg),
                                     jserve.init_cache(jcfg, 2, s_max))
    logits, cache = serve.prefill(tparams, tcfg, A.to_torch(prompt, tcfg),
                                  serve.init_cache(tcfg, 2, s_max, device="cpu"), device="cpu")
    assert int(cache["length"]) == int(jcache["length"]) == s_max
    tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)
    port_before = {k: A.f32(cache[k]).copy() for k in ("k", "v")}
    jax_before = {k: A.f32(jcache[k]) for k in ("k", "v")}
    jlogits, jcache = jserve.decode_step(jparams, jcfg, jnp.asarray(tok), jcache)
    logits, cache = serve.decode_step(tparams, tcfg, tok, cache, device="cpu")
    assert int(cache["length"]) == int(jcache["length"]) == s_max + 1
    A.assert_close(logits, jlogits, 1e-4, "float32")
    for key in ("k", "v"):
        for before, after in ((port_before[key], A.f32(cache[key])),
                              (jax_before[key], A.f32(jcache[key]))):
            row = after[:, :, s_max - 1:]
            assert not np.array_equal(row, before[:, :, s_max - 1:])
            want = jax.lax.dynamic_update_slice(before, row, (0, 0, s_max, 0, 0))
            np.testing.assert_array_equal(after, np.asarray(want))
        A.assert_close(A.f32(cache[key])[:, :, s_max - 1], A.f32(jcache[key])[:, :, s_max - 1],
                       1e-4, "float32")


def test_rwkv6_state_after_a_65536_token_prefill_matches_jax():
    jcfg, jparams, tcfg, tparams = A.models("rwkv6-1.6b", "float32", seed=7)
    s = 65_536
    tokens = A.batch(tcfg, 1, s, seed=7)["tokens"]
    jlogits, jcache = jax.jit(lambda p, b, c: jserve.prefill(p, jcfg, b, c))(
        jparams, {"tokens": jnp.asarray(tokens)}, jserve.init_cache(jcfg, 1, S_MAX))
    logits, cache = serve.prefill(tparams, tcfg, {"tokens": tokens},
                                  serve.init_cache(tcfg, 1, S_MAX, device="cpu"), device="cpu")
    assert int(cache["length"]) == int(jcache["length"]) == s
    A.assert_close(logits, jlogits, 1e-4, "float32")
    for key in ("wkv", "tm_shift", "cm_shift"):
        A.assert_close(cache[key], jcache[key], 1e-4, "float32")
    step = _jax_step(jcfg)
    for _ in range(3):
        tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)
        jlogits, jcache = step(jparams, jnp.asarray(tok), jcache)
        logits, cache = serve.decode_step(tparams, tcfg, tok, cache, device="cpu")
        A.assert_close(logits, jlogits, 1e-4, "float32")
    A.assert_close(cache["wkv"], jcache["wkv"], 1e-4, "float32")
    assert int(cache["length"]) == s + 3


#: (head dim, base): llama's, zamba2's and mixtral's.
ROPES = [(64, 500000.0), (112, 10000.0), (128, 1e6)]


@pytest.mark.parametrize("dh,theta", ROPES)
def test_rope_at_the_last_positions_of_a_500k_cache(dh, theta):
    """At positions 524,224-524,287 the float32 angles reach ~5e5 rad.  Each
    package's rotation is within 4e-7 of (1 + the row's largest |x|) of a
    float64 rotation of its own float32 angles; the two agree to that
    except in a frequency their tables round apart (at most one entry, by
    one float32 ulp), where they agree to ``position * |d inv|`` of it."""
    rng = np.random.default_rng(dh)
    x = rng.standard_normal((1, 64, 2, dh), dtype=np.float32)
    pos = np.arange(S_MAX - 64, S_MAX, dtype=np.int32)[None]
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta).numpy()
    want = np.asarray(jax_apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    scale = 1 + np.abs(x).max(-1, keepdims=True)
    tables = {"port": rope_frequencies(dh, theta).numpy(), "jax": np.asarray(jax_freqs(dh, theta))}
    for name, out in (("port", got), ("jax", want)):
        angles = (pos[..., None].astype(np.float32) * tables[name]).astype(np.float64)
        angles = angles[:, :, None, :]
        x1, x2 = np.split(x.astype(np.float64), 2, axis=-1)
        exact = np.concatenate([x1 * np.cos(angles) - x2 * np.sin(angles),
                                x1 * np.sin(angles) + x2 * np.cos(angles)], axis=-1)
        assert (np.abs(out - exact) <= 4e-7 * scale).all(), name
    d_inv = np.abs(tables["port"].astype(np.float64) - tables["jax"])
    assert (d_inv > 0).sum() <= 1
    assert (d_inv <= np.spacing(tables["jax"])).all()
    shift = np.tile(S_MAX * d_inv, 2)  # the angle's difference, over both halves
    assert (np.abs(got - want) <= (4e-7 + shift) * scale).all()


def test_jitted_jax_rope_is_far_less_exact_at_500k_positions_than_the_port():
    """XLA's CPU backend evaluates a jitted RoPE's float32 ``cos`` / ``sin``
    inexactly at large angles: at position 524,284, head dim 64 (llama's
    base), the jitted reference is off a float64 rotation of the same
    float32 angles by more than 1e-2, the eager ``jnp`` function and the
    port by under 4e-7 of (1 + |x|).  (Pinned: the decode tests above look
    the reference's ``cos`` / ``sin`` up instead.)"""
    dh, theta = 64, 500000.0
    x = np.random.default_rng(0).standard_normal((1, 1, 2, dh), dtype=np.float32)
    pos = np.array([[S_MAX - 4]], dtype=np.int32)
    angles = (pos[..., None].astype(np.float32) * np.asarray(jax_freqs(dh, theta)))
    angles = angles.astype(np.float64)[:, :, None, :]
    x1, x2 = np.split(x.astype(np.float64), 2, axis=-1)
    exact = np.concatenate([x1 * np.cos(angles) - x2 * np.sin(angles),
                            x1 * np.sin(angles) + x2 * np.cos(angles)], axis=-1)
    jitted = np.asarray(jax.jit(lambda a, p: jax_apply_rope(a, p, theta))(
        jnp.asarray(x), jnp.asarray(pos)))
    eager = np.asarray(jax_apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    port = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta).numpy()
    bound = 4e-7 * (1 + np.abs(x).max())
    assert np.abs(jitted - exact).max() > 1e-2
    assert np.abs(eager - exact).max() <= bound and np.abs(port - exact).max() <= bound
