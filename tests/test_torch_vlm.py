"""The vlm family -- ``models/common.py:apply_mrope`` and qwen2-vl-2b -- on
the port against the JAX package, on the CPU.

``apply_mrope`` is held to the JAX function (1e-6 in float32, one bf16
ulp of the row in bf16) on three distinct position streams: with one
stream broadcast to all three, a wrong band split would rotate alike and
pass.  The qwen2-vl smoke config (qkv biases, tied embeddings, M-RoPE
bands (4, 2, 2)) runs with 4 patch embeddings ahead of the text on qwen2-vl's
layout (patches on a 2 x 2 grid: t 0, h the row, w the column; the text's
three ids continuing from the largest plus one), as
``tests/test_torch_dense_archs.py`` holds its archs: the parameters bit for
bit (the biases drawn as the reference's zeros are replaced by seeded
values, so they take part); forward within 1e-4 in float32 and 2e-2 in
bf16; prefill with the patches and decode (the cache at S + 4 + 3, as
``tests/test_arch_smoke.py`` counts it) against ``repro.models.serve``;
the port's decode against its own teacher-forced forward; one-step
float32 gradients; full-width shapes and counts on the meta device.  The
decode step rotates all three streams by the cache length (the
reference's rule), so the teacher-forcing case gives the text the ids of
its positions in the sequence.
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
from repro.models import forward as jax_forward, init_params as jax_init_params, serve as jserve
from repro.models.common import apply_mrope as jax_apply_mrope
from repro.models.transformer import loss_fn as jax_loss_fn
from repro.training import optimizer as jopt
from repro_torch.configs import for_kernels, get_config
from repro_torch.configs.qwen2_vl_2b import N_PATCHES
from repro_torch.convert import model_params_from_reference
from repro_torch.kernels.decode_attention.kernel import SHAPES as DECODE_SHAPES
from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS
from repro_torch.models import serve
from repro_torch.models.common import apply_mrope, mrope_positions
from repro_torch.models.transformer import forward, init_params, loss_fn, param_shapes
from repro_torch.training.optimizer import global_norm

ARCH = "qwen2-vl-2b"


def _models(dtype, seed=2):
    """The smoke models with seeded qkv biases (the init's are zeros)."""
    jcfg, jparams, tcfg, _ = A.models(ARCH, dtype, seed)
    rng = np.random.default_rng(seed)
    layers = dict(jparams["layers"])
    for key in ("bq", "bk", "bv"):
        layers[key] = jnp.asarray(rng.normal(0, 0.3, layers[key].shape), jcfg.dtype)
    jparams = {**jparams, "layers": layers}
    tparams = model_params_from_reference(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh,sections", [(16, (4, 2, 2)), (128, (16, 24, 24))])
def test_apply_mrope_matches_jax_on_distinct_streams(dh, sections, dtype):
    rng = np.random.default_rng(dh)
    x = rng.standard_normal((2, 24, 3, dh)).astype(np.float32)
    pos = np.stack([rng.integers(0, 4, (2, 24)), rng.integers(0, 50, (2, 24)),
                    rng.integers(100, 4000, (2, 24))]).astype(np.int32)
    jd, td = A.DTYPES[dtype]
    want = jax_apply_mrope(jnp.asarray(x, jd), jnp.asarray(pos), 1e6, sections)
    got = apply_mrope(torch.from_numpy(x).to(td), torch.from_numpy(pos), 1e6, sections)
    assert got.dtype == td
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    else:
        A.assert_close(got, want, 2 ** -7, dtype)
    # the streams drive distinct bands: another split rotates differently
    other = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, sections[::-1])
    assert np.abs(other.numpy() - A.f32(want)).max() > 0.1


def test_apply_mrope_with_one_stream_is_rope():
    from repro_torch.models.common import apply_rope

    x = torch.randn(2, 8, 3, 128, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(8)[None].expand(2, 8)
    torch.testing.assert_close(apply_mrope(x, pos[None].expand(3, 2, 8), 1e6, (16, 24, 24)),
                               apply_rope(x, pos, 1e6), rtol=0, atol=0)
    with pytest.raises(ValueError, match="sum"):
        apply_mrope(x, pos[None].expand(3, 2, 8), 1e6, (16, 24, 16))


def test_mrope_positions_follow_qwen2_vl():
    pos = mrope_positions(2, N_PATCHES, 3)
    assert pos.shape == (3, 2, 259) and pos.dtype == torch.int64
    np.testing.assert_array_equal(pos[:, 1, 17], [0, 1, 1])  # row 1, column 1
    np.testing.assert_array_equal(pos[:, 0, 255], [0, 15, 15])
    np.testing.assert_array_equal(pos[:, 0, 256:], [[16, 17, 18]] * 3)
    with pytest.raises(ValueError, match="square"):
        mrope_positions(1, 5, 3)


def test_configs_equal_the_jax_configs():
    for preset in ("full", "smoke"):
        want = dataclasses.asdict(jax_get_config(ARCH, preset))
        got = dataclasses.asdict(get_config(ARCH, preset))
        assert {k: v for k, v in got.items() if k != "dtype"} == {
            k: v for k, v in want.items() if k != "dtype"}
    full = get_config(ARCH, "full")
    assert full.head_dim_ == 128 and full.head_dim_ in HEAD_DIMS and for_kernels(full) is full
    assert (128, full.n_heads // full.n_kv_heads) in DECODE_SHAPES
    wide = for_kernels(get_config(ARCH, "smoke"))  # a smoke run on the card
    assert wide.head_dim_ == 64 and wide.mrope_sections == (16, 8, 8)
    assert sum(wide.mrope_sections) == wide.head_dim_ // 2
    assert (wide.head_dim_, wide.n_heads // wide.n_kv_heads) in DECODE_SHAPES
    assert N_PATCHES == 256


def test_params_carry_over_bit_for_bit():
    _jcfg, jparams, tcfg, tparams = _models("bfloat16")
    want = dict(A.leaves(jparams))
    got = A.leaves(tparams)
    assert {k for k, _ in got} == set(want) and "lm_head" not in tparams
    assert {"layers/bq", "layers/bk", "layers/bv"} <= set(want)
    for key, w in got:
        np.testing.assert_array_equal(A.f32(w), A.f32(want[key]), err_msg=key)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_forward_with_patches_matches_jax_forward(dtype, tol):
    jcfg, jparams, tcfg, tparams = _models(dtype, seed=5)
    batch = A.batch(tcfg, 2, 16, seed=5)
    jlogits, _ = jax_forward(jparams, jcfg, A.to_jax(batch, jcfg))
    logits, aux = forward(tparams, tcfg, A.to_torch(batch, tcfg))
    assert logits.shape == (2, 16, tcfg.vocab) and float(aux) == 0.0
    A.assert_close(logits, jlogits, tol, dtype)


@pytest.mark.parametrize("dtype,tol_pre,tol_dec",
                         [("float32", 1e-4, 1e-4), ("bfloat16", 2e-2, 5e-2)])
def test_prefill_with_patches_and_decode_match_jax_serve(dtype, tol_pre, tol_dec):
    jcfg, jparams, tcfg, tparams = _models(dtype)
    b, s, s_max = 2, 8, 32
    batch = A.batch(tcfg, b, s, seed=2)
    batch.pop("labels", None)
    jcache = jserve.init_cache(jcfg, b, s_max)
    jlogits, jcache = jserve.prefill(jparams, jcfg, A.to_jax(batch, jcfg), jcache)
    cache = serve.init_cache(tcfg, b, s_max, device="cpu")
    logits, cache = serve.prefill(tparams, tcfg, A.to_torch(batch, tcfg), cache, device="cpu")
    A.assert_close(logits, jlogits, tol_pre, dtype)
    for _ in range(3):
        tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)  # both take JAX's
        jlogits, jcache = jserve.decode_step(jparams, jcfg, jnp.asarray(tok), jcache)
        logits, cache = serve.decode_step(tparams, tcfg, tok, cache, device="cpu")
        A.assert_close(logits, jlogits, tol_dec, dtype)
    for key in ("k", "v"):
        A.assert_close(cache[key], jcache[key], tol_dec, dtype)
    assert int(cache["length"]) == int(jcache["length"]) == s + A.SMOKE_PATCHES + 3


@pytest.mark.parametrize("dtype,tol_pre,tol_dec",
                         [("float32", 1e-4, 1e-4), ("bfloat16", 2e-2, 5e-2)])
def test_decode_matches_forward_teacher_forcing(dtype, tol_pre, tol_dec):
    _, tcfg = A.configs(ARCH, dtype)
    params = init_params(tcfg, seed=3, device="cpu")
    p = A.SMOKE_PATCHES
    pos = np.broadcast_to(np.arange(p + 8)[None, None], (3, 1, p + 8)).astype(np.int32).copy()
    pos[:, :, :p] = A.grid_positions(1, p, 0)  # patches on the grid
    batch = A.to_torch(A.batch(tcfg, 1, 8, seed=4, positions=pos), tcfg)
    full, _ = forward(params, tcfg, batch)
    cache = serve.init_cache(tcfg, 1, 16, device="cpu")
    prompt = {"tokens": batch["tokens"][:, :4], "patch_embeds": batch["patch_embeds"],
              "positions_3d": batch["positions_3d"][:, :, :p + 4]}
    pre, cache = serve.prefill(params, tcfg, prompt, cache, device="cpu")
    A.assert_close(pre, full[:, 3], tol_pre, dtype)
    for t in range(4, 8):
        logits, cache = serve.decode_step(params, tcfg, batch["tokens"][:, t], cache,
                                          device="cpu")
        A.assert_close(logits, full[:, t], tol_dec, dtype)
    assert int(cache["length"]) == p + 8


def test_one_step_gradients_equal_the_jax_gradients():
    """Every leaf (the qkv biases and the tied embedding included) within
    rtol 1e-4 of its largest |gradient|; the global norms within 1e-5."""
    jcfg, jparams, tcfg, tparams = _models("float32", seed=3)
    batch = A.batch(tcfg, 2, 24, seed=3, labels=True)
    leaves = A.leaves(tparams)
    for _k, t in leaves:
        t.requires_grad_()
    total, _ = loss_fn(tparams, tcfg, A.to_torch(batch, tcfg))
    grads = torch.autograd.grad(total, [t for _k, t in leaves])
    jgrads = jax.grad(lambda p: jax_loss_fn(p, jcfg, A.to_jax(batch, jcfg))[0])(jparams)
    want = dict(A.leaves(jgrads))
    for (key, _t), g in zip(leaves, grads):
        w = np.asarray(want[key])
        assert np.abs(w).max() > 0, key
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=key)
    assert float(global_norm(dict(enumerate(grads)))) == pytest.approx(
        float(jopt.global_norm(jgrads)), rel=1e-5)


def test_full_width_param_shapes_and_count_match_jax_without_allocating():
    jcfg = jax_get_config(ARCH, "full")
    tcfg = get_config(ARCH, "full")
    want = jax.eval_shape(lambda k: jax_init_params(jcfg, k)[0], jax.random.PRNGKey(0))
    got = A.shapes_of(param_shapes(tcfg))
    assert got == jax.tree.map(lambda a: tuple(a.shape), want)
    assert tcfg.params_count() == jcfg.params_count()
    shapes = jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, tuple))
    n = sum(int(np.prod(s)) for s in shapes)
    # not counted by params_count: the norms and the qkv biases
    norms = tcfg.d_model * (1 + 2 * tcfg.n_layers)
    biases = tcfg.n_layers * (tcfg.q_dim + 2 * tcfg.kv_dim)
    assert n == tcfg.params_count() + norms + biases
    assert sum(torch.empty(s, dtype=tcfg.dtype, device="meta").numel() for s in shapes) == n


def test_train_loop_feeds_stub_patches_and_resumes_bit_for_bit(tmp_path):
    """qwen2-vl smoke through ``TrainLoop`` on the CPU (float32): each batch
    carries ``N_PATCHES`` stub patch embeddings that ``batch_inputs`` draws
    from the stream position (the token stream holds no images), so a crash
    at 2 resumed to 4 equals the straight run in every loss and final
    parameter."""
    _, tcfg = A.configs(ARCH, "float32")
    stub = A.stub_patches(tcfg, seed=1, n_patches=N_PATCHES)
    batch = {"tokens": torch.zeros((2, 16), dtype=torch.long)}
    got = stub(3, batch)
    assert got["patch_embeds"].shape == (2, N_PATCHES, tcfg.d_model)
    assert torch.equal(got["positions_3d"], mrope_positions(2, N_PATCHES, 16))
    assert torch.equal(got["patch_embeds"], stub(3, batch)["patch_embeds"])
    assert not torch.equal(got["patch_embeds"], stub(4, batch)["patch_embeds"])
    straight, resumed, differ = A.crash_and_resume(tcfg, tmp_path, batch_inputs=stub)
    assert len(straight) == 4 and all(np.isfinite(straight))
    assert resumed == straight and not differ


def test_train_loop_refuses_a_vlm_model_without_batch_inputs(tmp_path):
    """The token stream holds no images: ``TrainLoop`` of a vlm model
    without ``batch_inputs`` raises before it draws a batch."""
    from repro_torch.training.loop import LoopConfig, TrainLoop
    from repro_torch.training.optimizer import AdamWConfig

    _, tcfg = A.configs(ARCH, "float32")
    with pytest.raises(ValueError, match="batch_inputs"):
        TrainLoop(tcfg, AdamWConfig(), LoopConfig(total_steps=1), ckpt_dir=tmp_path,
                  device="cpu")
