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


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("b,s,lengths", [(3, 16, [1, 9, 16]), (4, 4, [0, 4, 2, 3])])
def test_decode_plain_takes_per_sequence_lengths_as_the_jax_ref(b, s, lengths, window):
    """``length`` of shape [B]: one valid prefix per sequence, broadcast as
    the JAX oracle does, at B != S and at B == S (where a [S] mask would
    broadcast silently over the wrong axis)."""
    (jq, q), (jk, k), (jv, v) = _decode_inputs(b, 4, 4, s, 16, 11)
    got = _np(tdo.decode_attention(q, k, v, torch.tensor(lengths, dtype=torch.int32),
                                   window=window))
    want = _np(jdr.decode_attention(jq, jk, jv, jnp.asarray(lengths, jnp.int32), window=window))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


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


@pytest.mark.parametrize("window", [None, 64])
def test_decode_at_length_0_follows_the_jax_ref_not_the_pallas_kernel(window):
    """At length 0 every reference logit is -1e30, so ``ref.py``'s softmax
    weighs all S_max rows equally: the output is the mean of V.  The Pallas
    kernel skips every block (``k_start < length`` is never true) and
    returns zeros.  The port follows ``ref.py`` in both faces (its CUDA
    kernel reads the whole cache with equal logits; card test in
    ``test_torch_llm_kernels_cuda.py``)."""
    (jq, q), (jk, k), (jv, v) = _decode_inputs(2, 8, 2, 256, 64, 12)
    zero = torch.tensor(0, dtype=torch.int32)
    got = _np(tdo.decode_attention(q, k, v, zero, window=window))
    mean = np.repeat(_np(v).mean(axis=1), 4, axis=1)  # [B, Hkv, Dh] -> [B, H, Dh]
    np.testing.assert_allclose(got, mean, rtol=1e-5, atol=1e-6)
    rep_k, rep_v = jnp.repeat(jk, 4, axis=2), jnp.repeat(jv, 4, axis=2)
    ref = _np(jdr.decode_attention(jq, rep_k, rep_v, jnp.int32(0), window=window))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    pallas = _np(jdk.decode_attention_pallas(jq, rep_k, rep_v, jnp.int32(0), window=window,
                                             bs=128, interpret=True))
    assert not pallas.any()
    assert np.abs(mean).max() > 1e-3  # the two JAX routes really disagree


# The split-KV plan (``decode_attention/kernel.py``): the split count from
# host numbers, each block's slice from the device length.
SPLIT_SHAPES = [(64, 2), (64, 4), (112, 2), (112, 4)]  # (head dim, bytes per element)


@pytest.mark.parametrize("dh,itemsize", SPLIT_SHAPES)
@pytest.mark.parametrize("b,hkv,s_max", [(1, 8, 8192), (3, 2, 1024), (4, 8, 4128),
                                         (16, 8, 32768), (4, 32, 4128), (1, 1, 100),
                                         (128, 8, 256)])
def test_decode_split_ranges_tile_the_valid_range(dh, itemsize, b, hkv, s_max):
    """For every length 0..S_max (+2) and window, the splits' slices tile
    the rows the kernel reads exactly once, in order, none longer than the
    rounded chunk."""
    step = tdk.rows_per_step(dh, itemsize)
    n = tdk.split_plan(b, hkv, s_max, 3 * 132)
    assert 1 <= n <= tdk.MAX_SPLITS and (n == 1 or n <= s_max // tdk.MIN_SPLIT_ROWS)
    for length in sorted({*range(0, s_max + 3, max(1, s_max // 97)), 0, 1, s_max - 1, s_max,
                          step - 1, step, step + 1, n * step - 1, n * step, n * step + 1}):
        for window in (None, 1, 7, 100, s_max):
            lo, hi = tdk.valid_range(length, s_max, window)
            assert 0 <= lo < hi <= s_max or lo == hi == s_max == 0
            chunk = -(-(-(-(hi - lo) // n)) // step) * step
            pos = lo
            for split in range(n):
                a, z = tdk.split_range(lo, hi, n, step, split)
                assert a == pos and a <= z <= hi and z - a <= chunk
                pos = z
            assert pos == hi, (length, window, lo, hi, n)


@pytest.mark.parametrize("per_sm,want", [(3, (3, 12, 3)), (4, (4, 16, 4))])
def test_decode_split_plan_at_the_serving_shapes(per_sm, want):
    """One wave of split blocks on a 132-SM H100 holding 3 or 4 per SM: the
    32k cell's 16 x 8 groups, llama's B = 4 step (4 x 8) and zamba2's B = 4
    MHA step (4 x 32)."""
    slots = per_sm * 132
    got = (tdk.split_plan(16, 8, 32768, slots), tdk.split_plan(4, 8, 4128, slots),
           tdk.split_plan(4, 32, 4128, slots))
    assert got == want
    assert tdk.split_plan(1, 8, 300, slots) == 1  # too few rows for two splits
    assert tdk.split_plan(128, 8, 32768, slots) == 1  # more groups than slots
    assert tdk.split_plan(1, 1, 1 << 20, slots) == tdk.MAX_SPLITS
    assert tdk.rows_per_step(64, 2) == 64 and tdk.rows_per_step(112, 2) == 32
    assert tdk.rows_per_step(64, 4) == 32 and tdk.rows_per_step(112, 4) == 16


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


# Decode-step shapes of the served models: (T, D, F) of llama3.2-1b and
# zamba2-7b's shared FFN.
SWIGLU_DECODE = [(4, 2048, 8192), (16, 2048, 8192), (4, 3584, 14336), (16, 3584, 14336)]


@pytest.mark.parametrize("t,d,f", SWIGLU_DECODE)
def test_swiglu_decode_plan_covers_the_card_twice(t, d, f):
    """At decode, both products stream the weights over >= 2 blocks per
    SM of an H100 (132 SMs), and the K slices cover K exactly once."""
    for n, k in ((f, d), (d, f)):  # up, down
        p = tgk.plan(t, n, k, 132)
        assert p["path"] == "stream"
        assert p["col_tiles"] * p["splits"] >= 2 * 132
        assert p["kper"] % tgk.STREAM_BK == 0
        ranges = tgk.split_ranges(k, p["splits"], p["kper"])
        assert ranges[0][0] == 0 and ranges[-1][1] == k
        assert all(a < b for a, b in ranges)
        assert all(r[1] == s[0] for r, s in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("t", [1, 15, 16, 17, 129, 4100, 16384])
@pytest.mark.parametrize("n,k", [(8192, 2048), (2048, 8192), (520, 256), (256, 520)])
def test_swiglu_plan_covers_t_n_and_k_once(bf16, t, n, k):
    p = tgk.plan(t, n, k, 132, bf16)
    if t <= tgk.SMALL_T:
        assert p["path"] == "stream"
        bn = tgk.STREAM_BN
        ranges = tgk.split_ranges(k, p["splits"], p["kper"])
        covered = [i for a, b in ranges for i in range(a, b)]
        assert covered == list(range(k))
    else:
        assert p["path"] == "gemm"
        bm, bn = tgk.GEMM_TILE[bf16]
        assert (p["row_tiles"] - 1) * bm < t <= p["row_tiles"] * bm
    assert (p["col_tiles"] - 1) * bn < n <= p["col_tiles"] * bn


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
