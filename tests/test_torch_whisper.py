"""The audio family -- whisper-medium and ``models/common.py:layer_norm`` --
on the port against the JAX package, on the CPU.

The reference's whisper is held as it is, not as OpenAI's model: RMS norms
throughout, RoPE on the decoder's self attention, concatenated sinusoids
on the encoder (float32, times ``pos_scale``, cast to the frames' dtype
after the product), tanh-approximated GELU (``jax.nn.gelu``'s default;
torch's default erf form drifts ~1e-3 in float32), and a decode step whose
cross attention reads ``cfg.enc_seq`` rows of a cache that the prefill sized
to the frames.  The smoke config (2 + 2 layers, d_model 64, 4 heads, 32
frames) runs as ``tests/test_torch_vlm.py`` holds qwen2-vl: the parameters
bit for bit; forward and loss within 1e-4 in float32 and 2e-2 of (1 + the
row's largest |logit|) in bf16; prefill within those and 3 decode steps
within 1e-4 / 5e-2 of ``repro.models.serve``, also with 24 and 40 frames
against ``enc_seq`` 32; the port's decode against its own teacher-forced
forward; one-step float32 gradients within 1e-4 of each leaf's largest
|gradient|; full-width shapes and counts on the meta device; ``TrainLoop``
with stub frames resuming bit for bit.  The smoke model on the card
against the CPU is in ``tests/test_torch_llm_kernels_cuda.py``, which
imports no JAX.
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
from repro.models.common import layer_norm as jax_layer_norm
from repro.models.transformer import _sinusoidal as jax_sinusoidal, loss_fn as jax_loss_fn
from repro.training import optimizer as jopt
from repro_torch.configs import for_kernels, get_config
from repro_torch.kernels.decode_attention.kernel import SHAPES as DECODE_SHAPES
from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS
from repro_torch.models import serve
from repro_torch.models.common import layer_norm
from repro_torch.models.transformer import (
    _sinusoidal,
    forward,
    init_params,
    loss_fn,
    param_shapes,
)
from repro_torch.training.optimizer import global_norm

ARCH = "whisper-medium"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_layer_norm_matches_jax(with_bias, dtype):
    """Float32 inside, the biased variance, cast back: 1e-6 in float32, one
    bf16 ulp of the row in bf16.  Rows with a large mean are where a
    one-pass variance would lose digits."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 5, 96)) * 2 + 7).astype(np.float32)
    w = rng.standard_normal(96).astype(np.float32)
    bias = rng.standard_normal(96).astype(np.float32) if with_bias else None
    jd, td = A.DTYPES[dtype]
    want = jax_layer_norm(jnp.asarray(x, jd), jnp.asarray(w, jd),
                          None if bias is None else jnp.asarray(bias, jd))
    got = layer_norm(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td),
                     None if bias is None else torch.from_numpy(bias).to(td))
    assert got.dtype == td and got.shape == x.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    else:
        A.assert_close(got, want, 2 ** -8, dtype)
    if bias is not None:  # the bias takes part
        plain = layer_norm(torch.from_numpy(x), torch.from_numpy(w), None)
        assert np.abs(plain.numpy() - A.f32(want)).max() > 0.1


@pytest.mark.parametrize("s,d", [(32, 64), (1500, 1024)])
def test_sinusoidal_matches_jax(s, d):
    """[sin | cos] concatenated, float32; equal to the JAX table within
    float32 rounding of the angle (positions up to 1,499 rad: an ulp of the
    angle is ~1.2e-4 there)."""
    got = _sinusoidal(s, d)
    want = np.asarray(jax_sinusoidal(s, d))
    assert got.dtype == torch.float32 and got.shape == (s, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4 if s > 100 else 1e-6)
    np.testing.assert_array_equal(got[0, : d // 2].numpy(), np.zeros(d // 2))  # sin 0
    np.testing.assert_array_equal(got[0, d // 2:].numpy(), np.ones(d // 2))  # cos 0


def test_configs_equal_the_jax_configs():
    for preset in ("full", "smoke"):
        want = dataclasses.asdict(jax_get_config(ARCH, preset))
        got = dataclasses.asdict(get_config(ARCH, preset))
        assert {k: v for k, v in got.items() if k != "dtype"} == {
            k: v for k, v in want.items() if k != "dtype"}
    full = get_config(ARCH, "full")
    assert full.head_dim_ == 64 and full.head_dim_ in HEAD_DIMS and for_kernels(full) is full
    assert (64, 1) in DECODE_SHAPES and full.enc_seq == 1500
    wide = for_kernels(get_config(ARCH, "smoke"))  # a smoke run on the card
    assert (wide.head_dim_, wide.d_model, wide.d_ff, wide.enc_seq) == (64, 256, 512, 32)
    assert (wide.head_dim_, wide.n_heads // wide.n_kv_heads) in DECODE_SHAPES


def test_params_carry_over_bit_for_bit():
    _jcfg, jparams, tcfg, tparams = A.models(ARCH, "bfloat16")
    want = dict(A.leaves(jparams))
    got = A.leaves(tparams)
    assert {k for k, _ in got} == set(want)
    assert {"enc/pos_scale", "enc/final_norm", "dec/xq", "dec/xattn_norm"} <= set(want)
    for key, w in got:
        np.testing.assert_array_equal(A.f32(w), A.f32(want[key]), err_msg=key)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_forward_and_loss_match_jax(dtype, tol):
    jcfg, jparams, tcfg, tparams = A.models(ARCH, dtype, seed=5)
    batch = A.batch(tcfg, 2, 16, seed=5, labels=True)
    jlogits, _ = jax_forward(jparams, jcfg, A.to_jax(batch, jcfg))
    logits, aux = forward(tparams, tcfg, A.to_torch(batch, tcfg))
    assert logits.shape == (2, 16, tcfg.vocab) and logits.dtype == tcfg.dtype
    assert float(aux) == 0.0
    A.assert_close(logits, jlogits, tol, dtype)
    jtotal, _ = jax_loss_fn(jparams, jcfg, A.to_jax(batch, jcfg))
    total, metrics = loss_fn(tparams, tcfg, A.to_torch(batch, tcfg))
    assert float(total) == pytest.approx(float(jtotal), rel=tol)
    assert float(metrics["aux_loss"]) == 0.0


def test_forward_uses_the_tanh_gelu_and_the_frames():
    """The erf GELU moves the float32 logits past 1e-4 of the JAX ones (so
    the tolerance above would catch it), and the frames reach the logits."""
    import torch.nn.functional as F

    from repro_torch.models import transformer

    jcfg, jparams, tcfg, tparams = A.models(ARCH, "float32", seed=5)
    batch = A.batch(tcfg, 2, 16, seed=5)
    jlogits, _ = jax_forward(jparams, jcfg, A.to_jax(batch, jcfg))
    erf = F.gelu
    try:
        transformer.F.gelu = lambda x, approximate="none": erf(x)
        logits, _ = forward(tparams, tcfg, A.to_torch(batch, tcfg))
    finally:
        transformer.F.gelu = erf
    assert np.abs(A.f32(logits) - A.f32(jlogits)).max() > 1e-4
    other = dict(batch, frames=batch["frames"][::-1].copy())
    moved, _ = forward(tparams, tcfg, A.to_torch(other, tcfg))
    assert np.abs(A.f32(moved) - A.f32(jlogits)).max() > 1e-2


@pytest.mark.parametrize("frames", [32, 24])
@pytest.mark.parametrize("dtype,tol_pre,tol_dec",
                         [("float32", 1e-4, 1e-4), ("bfloat16", 2e-2, 5e-2)])
def test_prefill_and_decode_match_jax_serve(dtype, tol_pre, tol_dec, frames):
    """24 frames of ``enc_seq`` 32: both packages size the cross cache to
    the frames and decode over ``enc_seq`` rows, every one of them valid."""
    jcfg, jparams, tcfg, tparams = A.models(ARCH, dtype)
    b, s, s_max = 2, 8, 32
    batch = A.batch(tcfg, b, s, seed=2, frames=frames)
    jcache = jserve.init_cache(jcfg, b, s_max)
    jlogits, jcache = jserve.prefill(jparams, jcfg, A.to_jax(batch, jcfg), jcache)
    cache = serve.init_cache(tcfg, b, s_max, device="cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: tuple(v.shape) for k, v in jserve.init_cache(jcfg, b, s_max).items()}
    logits, cache = serve.prefill(tparams, tcfg, A.to_torch(batch, tcfg), cache, device="cpu")
    A.assert_close(logits, jlogits, tol_pre, dtype)
    assert tuple(cache["xk"].shape) == tuple(jcache["xk"].shape) == (2, b, frames, 4, 16)
    for _ in range(3):
        tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)  # both take JAX's
        jlogits, jcache = jserve.decode_step(jparams, jcfg, jnp.asarray(tok), jcache)
        logits, cache = serve.decode_step(tparams, tcfg, tok, cache, device="cpu")
        A.assert_close(logits, jlogits, tol_dec, dtype)
    for key in ("k", "v", "xk", "xv"):
        A.assert_close(cache[key], jcache[key], tol_dec, dtype)
    assert int(cache["length"]) == int(jcache["length"]) == s + 3


def test_decode_reads_enc_seq_cross_rows():
    """With 40 frames of ``enc_seq`` 32 the prefill attends over all 40
    cross rows, but a decode step reads the first 32 only (the reference's
    ``attention_decode(q, xk, xv, enc_seq)``): rows 32-39 may hold anything.
    The same step equals the JAX step."""
    jcfg, jparams, tcfg, tparams = A.models(ARCH, "float32")
    batch = A.batch(tcfg, 2, 8, seed=4, frames=40)
    jcache = jserve.init_cache(jcfg, 2, 16)
    jlogits, jcache = jserve.prefill(jparams, jcfg, A.to_jax(batch, jcfg), jcache)
    cache = serve.init_cache(tcfg, 2, 16, device="cpu")
    _, cache = serve.prefill(tparams, tcfg, A.to_torch(batch, tcfg), cache, device="cpu")
    assert cache["xk"].shape[2] == 40
    tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)
    jlogits, _ = jserve.decode_step(jparams, jcfg, jnp.asarray(tok), jcache)
    spoiled = {k: v.clone() for k, v in cache.items()}
    for key in ("xk", "xv"):
        spoiled[key][:, :, 32:] = 1e3
    want, _ = serve.decode_step(tparams, tcfg, tok, cache, device="cpu")
    got, _ = serve.decode_step(tparams, tcfg, tok, spoiled, device="cpu")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    A.assert_close(got, jlogits, 1e-4, "float32")
    spoiled["xk"][:, :, 31] = 1e3  # a row decode reads
    moved, _ = serve.decode_step(tparams, tcfg, tok, spoiled, device="cpu")
    assert float((moved - want).abs().max()) > 1e-3


@pytest.mark.parametrize("dtype,tol_pre,tol_dec",
                         [("float32", 1e-4, 1e-4), ("bfloat16", 2e-2, 5e-2)])
def test_decode_matches_forward_teacher_forcing(dtype, tol_pre, tol_dec):
    _, tcfg = A.configs(ARCH, dtype)
    params = init_params(tcfg, seed=3, device="cpu")
    batch = A.to_torch(A.batch(tcfg, 2, 8, seed=4), tcfg)
    full, _ = forward(params, tcfg, batch)
    cache = serve.init_cache(tcfg, 2, 16, device="cpu")
    prompt = {"tokens": batch["tokens"][:, :4], "frames": batch["frames"]}
    pre, cache = serve.prefill(params, tcfg, prompt, cache, device="cpu")
    A.assert_close(pre, full[:, 3], tol_pre, dtype)
    for t in range(4, 8):
        logits, cache = serve.decode_step(params, tcfg, batch["tokens"][:, t], cache,
                                          device="cpu")
        A.assert_close(logits, full[:, t], tol_dec, dtype)
    assert int(cache["length"]) == 8


def test_one_step_gradients_equal_the_jax_gradients():
    """Every leaf (``pos_scale``, the encoder's and the cross attention's
    included) within rtol 1e-4 of its largest |gradient|; the global norms
    within 1e-5."""
    jcfg, jparams, tcfg, tparams = A.models(ARCH, "float32", seed=3)
    batch = A.batch(tcfg, 2, 24, seed=3, labels=True)
    leaves = A.leaves(tparams)
    for _k, t in leaves:
        t.requires_grad_()
    total, _ = loss_fn(tparams, tcfg, A.to_torch(batch, tcfg))
    grads = torch.autograd.grad(total, [t for _k, t in leaves])
    jgrads = jax.grad(lambda p: jax_loss_fn(p, jcfg, A.to_jax(batch, jcfg))[0])(jparams)
    want = dict(A.leaves(jgrads))
    assert {"enc/pos_scale", "enc/wq", "dec/xk"} <= set(want)
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
    d, le, ld = tcfg.d_model, tcfg.enc_layers, tcfg.n_layers
    attn = 2 * d * tcfg.q_dim + 2 * d * tcfg.kv_dim
    # params_count counts two attentions per encoder layer (the reference's
    # formula) and no norms: the stacks' norms, the two final norms and
    # pos_scale
    norms = 2 * le * d + 3 * ld * d + 2 * d + 1
    assert n == tcfg.params_count() - le * attn + norms
    assert n == 810_987_521  # 0.81 B: 1.62 GB in bf16
    assert sum(torch.empty(s, dtype=tcfg.dtype, device="meta").numel() for s in shapes) == n


def test_train_loop_feeds_stub_frames_and_resumes_bit_for_bit(tmp_path):
    """whisper smoke through ``TrainLoop`` on the CPU (float32): each batch
    carries ``enc_seq`` stub frames that ``batch_inputs`` draws from the
    stream position (the token stream holds no audio), so a crash at 2
    resumed to 4 equals the straight run in every loss and final
    parameter."""
    _, tcfg = A.configs(ARCH, "float32")
    stub = A.stub_frames(tcfg, seed=1)
    batch = {"tokens": torch.zeros((2, 16), dtype=torch.long)}
    got = stub(3, batch)["frames"]
    assert got.shape == (2, tcfg.enc_seq, tcfg.d_model) and got.dtype == tcfg.dtype
    assert torch.equal(got, stub(3, batch)["frames"])
    assert not torch.equal(got, stub(4, batch)["frames"])
    straight, resumed, differ = A.crash_and_resume(tcfg, tmp_path, batch_inputs=stub)
    assert len(straight) == 4 and all(np.isfinite(straight))
    assert straight[-1] < straight[0]
    assert resumed == straight and not differ


def test_train_loop_and_launcher_refuse_an_audio_model_without_frames(tmp_path):
    """The token stream holds no audio: ``TrainLoop`` of an audio model
    without ``batch_inputs`` raises before it draws a batch, and the
    training launcher refuses whisper as it refuses qwen2-vl."""
    from repro_torch.launch import train as launcher
    from repro_torch.training.loop import LoopConfig, TrainLoop
    from repro_torch.training.optimizer import AdamWConfig

    _, tcfg = A.configs(ARCH, "float32")
    with pytest.raises(ValueError, match="frames"):
        TrainLoop(tcfg, AdamWConfig(), LoopConfig(total_steps=1), ckpt_dir=tmp_path,
                  device="cpu")
    with pytest.raises(SystemExit, match="audio frames"):
        launcher.main(["--arch", ARCH, "--device", "cpu", "--steps", "1",
                       "--ckpt", str(tmp_path / "ckpt")])
