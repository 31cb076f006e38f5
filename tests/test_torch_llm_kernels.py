"""The port's LLM kernels against the JAX package.

The plain PyTorch versions (``repro_torch/kernels/{flash_attention,
decode_attention,swiglu}/ref.py``, what the dispatch runs for CPU tensors)
are held against the JAX package's jnp references and its Pallas kernels
in interpret mode, on the same seeded numpy inputs, at the shapes of
``tests/test_kernels_all.py`` and at zamba2's head dim 112 (MHA).  Float32 agrees with the references to
1e-5 (the same math, summed in another order) and with the Pallas kernels
to 2e-3 (their tolerance against their own references); bf16 to 3e-2 for
attention and to 5e-2 of the output's magnitude for SwiGLU (bf16 rounding
of the outputs and, in SwiGLU, of the gate and up products).  The CUDA
kernels run only on a card: ``tests/test_torch_llm_kernels_cuda.py`` holds
them against these plain versions, and ``chip_smoke.py`` at the model's
shapes.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import kernel as jdk, ref as jdr
from repro.kernels.flash_attention import kernel as jfk, ref as jfr
from repro.kernels.swiglu import kernel as jgk, ref as jgr
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.decode_attention import kernel as tdk, ops as tdo, ref as tdr
from repro_torch.kernels.flash_attention import kernel as tfk, ops as tfo, ref as tfr
from repro_torch.kernels.swiglu import kernel as tgk, ops as tgo

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pair(x, dtype):
    """The same values in both frameworks (bf16 rounds identically)."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x.astype(jnp.float32))


# --------------------------------------------------------------------------- #
# flash attention
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("sq,skv", [(128, 128), (128, 256), (100, 130)])
def test_flash_plain_matches_jax_ref_causal(dtype, tol, sq, skv):
    b, h, dh = 1, 2, 64
    (jq, q), (jk, k), (jv, v) = (_pair(_normal(s, i), dtype) for i, s in
                                 enumerate([(b, h, sq, dh), (b, h, skv, dh), (b, h, skv, dh)]))
    got = tfo.attention(q, k, v, causal=True)
    want = jfr.attention(jq, jk, jv, causal=True)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (b, h, sq, dh)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("mode", ["window", "bidirectional"])
def test_flash_plain_matches_jax_ref_window_and_bidirectional(mode):
    b, h, s, dh = 2, 1, 256, 32
    (jq, q), (jk, k), (jv, v) = (_pair(_normal((b, h, s, dh), 10 + i), "float32")
                                 for i in range(3))
    kw = dict(causal=True, window=64) if mode == "window" else dict(causal=False)
    np.testing.assert_allclose(_np(tfo.attention(q, k, v, **kw)),
                               _np(jfr.attention(jq, jk, jv, **kw)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["causal", "causal_offset", "window", "bidirectional"])
def test_flash_plain_matches_pallas_interpret(case):
    sq, skv, kw = {"causal": (128, 128, dict(causal=True)),
                   "causal_offset": (128, 256, dict(causal=True)),
                   "window": (256, 256, dict(causal=True, window=64)),
                   "bidirectional": (128, 128, dict(causal=False))}[case]
    b, h, dh = 1, 2, 64
    (jq, q), (jk, k), (jv, v) = (_pair(_normal(s, 20 + i), "float32") for i, s in
                                 enumerate([(b, h, sq, dh), (b, h, skv, dh), (b, h, skv, dh)]))
    want = jfk.flash_attention_pallas(jq, jk, jv, bq=64, bk=64, interpret=True, **kw)
    np.testing.assert_allclose(_np(tfo.attention(q, k, v, **kw)), _np(want),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_flash_plain_gqa_matches_jax_ref_with_repeated_kv(dtype, tol):
    b, h, hkv, s, dh = 2, 8, 2, 96, 64
    (jq, q) = _pair(_normal((b, h, s, dh), 30), dtype)
    (jk, k), (jv, v) = (_pair(_normal((b, hkv, s, dh), 31 + i), dtype) for i in range(2))
    want = jfr.attention(jq, jnp.repeat(jk, h // hkv, axis=1), jnp.repeat(jv, h // hkv, axis=1),
                         causal=True)
    np.testing.assert_allclose(_np(tfo.attention(q, k, v, causal=True)), _np(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_flash_plain_at_zamba2_head_dim_matches_jax_ref_and_pallas(dtype, tol):
    """zamba2's shared block: MHA at head dim 112 (the Pallas kernel in
    float32 only, at its own 2e-3)."""
    b, h, s, dh = 1, 2, 128, 112
    (jq, q), (jk, k), (jv, v) = (_pair(_normal((b, h, s, dh), 50 + i), dtype)
                                 for i in range(3))
    got = _np(tfo.attention(q, k, v, causal=True))
    np.testing.assert_allclose(got, _np(jfr.attention(jq, jk, jv, causal=True)), rtol=tol,
                               atol=tol)
    if dtype == "float32":
        want = jfk.flash_attention_pallas(jq, jk, jv, causal=True, bq=64, bk=64, interpret=True)
        np.testing.assert_allclose(got, _np(want), rtol=2e-3, atol=2e-3)


# --------------------------------------------------------------------------- #
# decode attention
# --------------------------------------------------------------------------- #
def _decode_inputs(b, h, hkv, s, dh, seed, dtype="float32"):
    return (_pair(_normal((b, h, dh), seed), dtype),
            _pair(_normal((b, s, hkv, dh), seed + 1), dtype),
            _pair(_normal((b, s, hkv, dh), seed + 2), dtype))


@pytest.mark.parametrize("length", [1, 100, 256, 511])
def test_decode_plain_matches_jax_ref_and_pallas(length):
    (jq, q), (jk, k), (jv, v) = _decode_inputs(2, 4, 4, 512, 32, 0)
    got = _np(tdo.decode_attention(q, k, v, torch.tensor(length, dtype=torch.int32)))
    np.testing.assert_allclose(got, _np(jdr.decode_attention(jq, jk, jv, jnp.int32(length))),
                               rtol=1e-5, atol=1e-5)
    pallas = jdk.decode_attention_pallas(jq, jk, jv, jnp.int32(length), bs=128, interpret=True)
    np.testing.assert_allclose(got, _np(pallas), rtol=2e-3, atol=2e-3)


def test_decode_plain_window_matches_jax_ref_and_pallas():
    (jq, q), (jk, k), (jv, v) = _decode_inputs(1, 2, 2, 512, 32, 3)
    got = _np(tdo.decode_attention(q, k, v, torch.tensor(400, dtype=torch.int32), window=64))
    np.testing.assert_allclose(
        got, _np(jdr.decode_attention(jq, jk, jv, jnp.int32(400), window=64)),
        rtol=1e-5, atol=1e-5)
    pallas = jdk.decode_attention_pallas(jq, jk, jv, jnp.int32(400), window=64, bs=128,
                                         interpret=True)
    np.testing.assert_allclose(got, _np(pallas), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_decode_plain_gqa_matches_jax_ref_with_repeated_kv(dtype, tol):
    (jq, q), (jk, k), (jv, v) = _decode_inputs(3, 8, 2, 300, 64, 6, dtype)
    length = 257
    want = jdr.decode_attention(jq, jnp.repeat(jk, 4, axis=2), jnp.repeat(jv, 4, axis=2),
                                jnp.int32(length))
    got = tdo.decode_attention(q, k, v, torch.tensor(length, dtype=torch.int32))
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_decode_plain_at_zamba2_head_dim_matches_jax_ref_and_pallas():
    (jq, q), (jk, k), (jv, v) = _decode_inputs(2, 4, 4, 256, 112, 9)
    got = _np(tdo.decode_attention(q, k, v, torch.tensor(200, dtype=torch.int32)))
    np.testing.assert_allclose(got, _np(jdr.decode_attention(jq, jk, jv, jnp.int32(200))),
                               rtol=1e-5, atol=1e-5)
    pallas = jdk.decode_attention_pallas(jq, jk, jv, jnp.int32(200), bs=128, interpret=True)
    np.testing.assert_allclose(got, _np(pallas), rtol=2e-3, atol=2e-3)


def test_decode_plain_matches_causal_attention_last_row():
    """Decode at length L equals full causal attention's last row."""
    b, h, s, dh = 1, 2, 256, 32
    q_full = torch.from_numpy(_normal((b, h, s, dh), 6))
    kc = torch.from_numpy(_normal((b, s, h, dh), 7))
    vc = torch.from_numpy(_normal((b, s, h, dh), 8))
    full = tfr.attention(q_full, kc.transpose(1, 2), vc.transpose(1, 2), causal=True)
    got = tdr.decode_attention(q_full[:, :, -1], kc, vc, torch.tensor(s, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), full[:, :, -1].numpy(), rtol=2e-5, atol=2e-5)


# --------------------------------------------------------------------------- #
# swiglu
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("t,d,f", [(128, 64, 256), (100, 48, 136)])
def test_swiglu_plain_matches_jax_ref(dtype, tol, t, d, f):
    (jx, x), (jg, wg), (ju, wu) = (_pair(_normal(s, i), dtype) for i, s in
                                   enumerate([(t, d), (d, f), (d, f)]))
    (jo, wo) = _pair(_normal((f, d), 3), dtype)
    got = _np(tgo.swiglu(x, wg, wu, wo))
    want = _np(jgr.swiglu(jx, jg, ju, jo))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


def test_swiglu_plain_matches_pallas_interpret():
    t, d, f = 128, 64, 256
    (jx, x), (jg, wg), (ju, wu) = (_pair(_normal(s, 40 + i), "float32") for i, s in
                                   enumerate([(t, d), (d, f), (d, f)]))
    (jo, wo) = _pair(_normal((f, d), 43), "float32")
    want = _np(jgk.swiglu_pallas(jx, jg, ju, jo, bt=64, bf=64, interpret=True))
    np.testing.assert_allclose(_np(tgo.swiglu(x, wg, wu, wo)), want, rtol=2e-3,
                               atol=2e-3 * np.abs(want).max())


def test_cpu_dispatch_never_launches():
    before = dict(LAUNCHES)
    x = torch.randn(4, 8)
    tgo.swiglu(x, torch.randn(8, 16), torch.randn(8, 16), torch.randn(16, 8))
    q = torch.randn(1, 2, 8, 32)
    tfo.attention(q, q, q)
    tdo.decode_attention(q[:, :, 0], q.transpose(1, 2), q.transpose(1, 2), 3)
    assert dict(LAUNCHES) == before


def test_kernel_wrappers_refuse_cpu_tensors():
    q = torch.randn(1, 2, 8, 32)
    with pytest.raises(ValueError, match="CUDA"):
        tfk.attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        tdk.decode_attention(q[:, :, 0], q.transpose(1, 2).contiguous(),
                             q.transpose(1, 2).contiguous(), 3)
    x = torch.randn(4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tgk.swiglu(x, torch.randn(8, 16), torch.randn(8, 16), torch.randn(16, 8))
