"""The port's LLM CUDA kernels against their plain PyTorch versions, on the
card.

These tests need a CUDA device and skip without one (the kernels have no
CPU mode).  They import no JAX, so they also run where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_llm_kernels_cuda.py

Attention: kernel and plain version both compute the softmax and the sums
in float32 and round the output once, so in bf16 they may differ by one
ulp, 2^-7 of the largest value in the output row; the limit is two ulps.
The bf16 flash kernel also rounds each softmax weight to bf16 before the
P V product on the tensor cores (as FlashAttention-3 and SDPA do): <=
2^-9 relative per weight, random in sign, so its effect on an output is
far below one ulp of the row's largest value.  In float32 the limit,
2e-5 * (1 + |plain|), sits above summation-order noise (the decode
kernel merges its blocks' ranges in another order) and below what one
key too many or too few moves an output.  SwiGLU: the plain version rounds
the gate and up products to bf16, the kernel rounds their silu product
once, so bf16 is held to 5e-2 of the output's magnitude.
"""

from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.decode_attention import kernel as tdk, ref as tdr
from repro_torch.kernels.flash_attention import kernel as tfk, ref as tfr
from repro_torch.kernels.swiglu import kernel as tgk, ref as tgr

ATTN_TOL = {torch.bfloat16: 2 ** -6, torch.float32: 2e-5}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _assert_attention_close(got, want):
    """bf16: |d| <= tol * max |want| over the row; float32: tol * (1 + |want|)."""
    bf16, tol = want.dtype == torch.bfloat16, ATTN_TOL[want.dtype]
    got, want = got.double(), want.double()
    limit = tol * want.abs().amax(-1, keepdim=True) if bf16 else tol * (1 + want.abs())
    diff = (got - want).abs()
    assert torch.isfinite(got).all()
    assert bool((diff <= limit).all()), f"max abs err {float(diff.max())}"


# (B, Sq, Skv, window, causal): Sq and Skv off the 64 / 128-row tiles and
# off the bf16 kernel's 128-key stage, a single query, windows crossing key
# tiles and inside one, bidirectional with Sq < Skv and Sq > Skv, and
# enough (batch, head) blocks that the reversed (longest first) query-tile
# order runs over several waves.
FLASH_CASES = [(2, 200, 200, None, True), (2, 128, 300, None, True), (2, 256, 256, 64, True),
               (2, 129, 300, None, True), (2, 1, 77, None, True), (2, 300, 300, 100, True),
               (2, 200, 330, 64, True), (2, 200, 300, None, False), (2, 77, 1, None, False),
               (8, 1000, 1000, None, True), (2, 77, 77, None, True), (2, 77, 333, None, False),
               (1, 129, 1000, 200, True)]
# The head dims the kernels serve: 64 (llama, whisper), 112 (zamba2, kimi;
# the bf16 kernel's second 64-column box half past the row) and 128.
FLASH_DHS = (64, 112, 128)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", FLASH_DHS)
@pytest.mark.parametrize("b,sq,skv,window,causal", FLASH_CASES)
def test_cuda_flash_matches_plain(cuda_device, dtype, dh, b, sq, skv, window, causal):
    """Four query heads per KV head at each head dim."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(b, 8, sq, dh, generator=gen).to(cuda_device, dtype)
    k = torch.randn(b, 2, skv, dh, generator=gen).to(cuda_device, dtype)
    v = torch.randn(b, 2, skv, dh, generator=gen).to(cuda_device, dtype)
    got = tfk.attention(q, k, v, causal=causal, window=window)
    want = tfr.attention(q, k, v, causal=causal, window=window)
    assert got.dtype == want.dtype and got.shape == want.shape
    _assert_attention_close(got, want)


def test_cuda_flash_bf16_refuses_misaligned_rows(cuda_device):
    """The bf16 kernel reads its tiles through TMA, which takes 16-byte-
    aligned rows: a base pointer or a stride off the 16-byte grid raises (no
    route to another kernel)."""
    flat = torch.randn(2 * 8 * 64 * 64 + 1, device=cuda_device).to(torch.bfloat16)
    shifted = flat[1:].view(2, 64, 8, 64).transpose(1, 2)  # base 2 bytes off
    ok = torch.randn(2, 64, 2, 64, device=cuda_device).to(torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="16-byte"):
        tfk.attention(shifted, ok, ok)
    wide = torch.randn(2, 64, 2, 65, device=cuda_device).to(torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        tfk.attention(flat[:-1].view(2, 64, 8, 64).transpose(1, 2), ok,
                      wide[..., :64].transpose(1, 2))  # head stride 65
    tfk.attention(flat[:-1].view(2, 64, 8, 64).transpose(1, 2), ok, ok)  # aligned: runs


# (B, S_max, length, window): lengths 0 (the mean of V, as ref.py), 1, one
# 64-row tile, around a tile boundary, S_max; a window shorter than a
# block's range; B = 1 (a group over many blocks) and B = 16 (few).
DECODE_CASES = [(3, 1024, 1, None), (3, 1024, 1000, None), (3, 1024, 1000, 100),
                (3, 1024, 0, None), (3, 1024, 0, 100), (3, 1024, 64, None),
                (3, 1024, 255, None), (3, 1024, 256, None), (3, 1024, 257, None),
                (3, 1024, 1024, None), (3, 1024, 1024, 30), (1, 8192, 5000, None),
                (1, 8192, 8192, 700), (1, 8192, 0, None), (16, 1024, 777, None),
                (16, 1024, 1024, 50)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s_max,length,window", DECODE_CASES)
def test_cuda_decode_matches_plain(cuda_device, dtype, b, s_max, length, window):
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(b, 8, 64, generator=gen).to(cuda_device, dtype)
    k = torch.randn(b, s_max, 2, 64, generator=gen).to(cuda_device, dtype)
    v = torch.randn(b, s_max, 2, 64, generator=gen).to(cuda_device, dtype)
    n = torch.tensor(length, dtype=torch.int32, device=cuda_device)
    got = tdk.decode_attention(q, k, v, n, window=window)
    want = tdr.decode_attention(q, k, v, n, window=window)
    assert got.dtype == want.dtype and got.shape == want.shape
    _assert_attention_close(got, want)


# Head dim 128 (phi3-medium-14b, yi-34b, command-r-35b): flash at phi3's
# 40 / 10 heads (cut to 8 / 2) off the tiles, windowed and bidirectional.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,window,causal", [
    (2, 200, 200, None, True), (2, 129, 300, None, True), (2, 300, 300, 100, True),
    (2, 200, 300, None, False), (1, 1, 77, None, True)])
def test_cuda_flash_head_dim_128_matches_plain(cuda_device, dtype, b, sq, skv, window, causal):
    gen = torch.Generator().manual_seed(4)
    q = torch.randn(b, sq, 8, 128, generator=gen).to(cuda_device, dtype).transpose(1, 2)
    k = torch.randn(b, skv, 2, 128, generator=gen).to(cuda_device, dtype).transpose(1, 2)
    v = torch.randn(b, skv, 2, 128, generator=gen).to(cuda_device, dtype).transpose(1, 2)
    got = tfk.attention(q, k, v, causal=causal, window=window)
    _assert_attention_close(got, tfr.attention(q, k, v, causal=causal, window=window))


def _flash_inputs(dev, b, hq, hkv, sq, skv, dh, seed):
    """q [B, Hq, Sq, Dh], k / v [B, Hkv, Skv, Dh], bf16, contiguous heads-first."""
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(b, n, s, dh, generator=gen).to(dev, torch.bfloat16)
                 for n, s in ((hq, sq), (hkv, skv), (hkv, skv)))


@pytest.mark.parametrize("dh", FLASH_DHS)
@pytest.mark.parametrize("n_rep", [1, 4, 8])
def test_cuda_flash_bf16_gqa_ratios(cuda_device, dh, n_rep):
    """Query head h reads KV head h / n_rep through the K / V tensor maps."""
    q, k, v = _flash_inputs(cuda_device, 2, 8, 8 // n_rep, 300, 300, dh, seed=11)
    _assert_attention_close(tfk.attention(q, k, v), tfr.attention(q, k, v))


@pytest.mark.parametrize("dh", FLASH_DHS)
def test_cuda_flash_bf16_cross_attention_sq_below_skv(cuda_device, dh):
    """whisper's cross attention: 224 prompt rows over 1,500 frames, no mask."""
    q, k, v = _flash_inputs(cuda_device, 2, 4, 4, 224, 1500, dh, seed=12)
    _assert_attention_close(tfk.attention(q, k, v, causal=False),
                            tfr.attention(q, k, v, causal=False))


@pytest.mark.parametrize("dh", FLASH_DHS)
def test_cuda_flash_bf16_takes_the_model_layout(cuda_device, dh):
    """[B, S, H, Dh] buffers passed as their transpose(1, 2) views: the
    tensor maps step over the sequence and head strides as given, so the
    result is the contiguous heads-first call's, bit for bit."""
    gen = torch.Generator().manual_seed(13)
    q, k, v = (torch.randn(2, 333, n, dh, generator=gen).to(cuda_device, torch.bfloat16)
               .transpose(1, 2) for n in (8, 2, 2))
    got = tfk.attention(q, k, v, window=100)
    flat = tfk.attention(*(t.contiguous() for t in (q, k, v)), window=100)
    assert torch.equal(got, flat)
    _assert_attention_close(got, tfr.attention(q, k, v, window=100))


# Every instantiated (head dim, query heads per KV head) pair: the three
# dense 128-dim archs', mixtral's and qwen2-vl's (128, 6), kimi's (112, 8),
# whisper's (64, 1) and the smoke configs' at the kernels' head dim 64
# (ratios 2, 3, 7, 8), each from length 0 to S_max.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh,n_rep", [(128, 4), (128, 6), (128, 7), (128, 8), (112, 8),
                                      (64, 1), (64, 2), (64, 3), (64, 7), (64, 8)])
@pytest.mark.parametrize("length,window", [(0, None), (257, None), (1024, 100)])
def test_cuda_decode_gqa_pairs_match_plain(cuda_device, dtype, dh, n_rep, length, window):
    gen = torch.Generator().manual_seed(5)
    b, hkv, s_max = 3, 2, 1024
    q = torch.randn(b, hkv * n_rep, dh, generator=gen).to(cuda_device, dtype)
    k = torch.randn(b, s_max, hkv, dh, generator=gen).to(cuda_device, dtype)
    v = torch.randn(b, s_max, hkv, dh, generator=gen).to(cuda_device, dtype)
    n = torch.tensor(length, dtype=torch.int32, device=cuda_device)
    got = tdk.decode_attention(q, k, v, n, window=window)
    _assert_attention_close(got, tdr.decode_attention(q, k, v, n, window=window))


# whisper-medium's attention (16 heads of 64, MHA) at its serving shapes:
# the encoder's bidirectional 1,500 frames (off the 64 / 128-row tiles) and
# the cross attention of a 224-token prompt over them.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv", [(2, 1500, 1500), (2, 224, 1500), (3, 1, 1500)])
def test_cuda_flash_at_whisper_shapes_matches_plain(cuda_device, dtype, b, sq, skv):
    gen = torch.Generator().manual_seed(9)
    q = torch.randn(b, sq, 16, 64, generator=gen).to(cuda_device, dtype).transpose(1, 2)
    k, v = (torch.randn(b, skv, 16, 64, generator=gen).to(cuda_device, dtype).transpose(1, 2)
            for _ in range(2))
    got = tfk.attention(q, k, v, causal=False)
    want = tfr.attention(q, k, v, causal=False)
    assert got.dtype == want.dtype and got.shape == want.shape
    _assert_attention_close(got, want)


# whisper-medium's decode, (64, 1) at B 16: the cross cache of 1,500 rows
# read whole, the self cache of 448 (n_text_ctx) at a step over 225 rows and
# empty, and a cross length past the rows (the reference's enc_seq over
# fewer frames: every row counts).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s_max,length", [(1500, 1500), (448, 225), (448, 0), (24, 32)])
def test_cuda_decode_at_whisper_shapes_matches_plain(cuda_device, dtype, s_max, length):
    gen = torch.Generator().manual_seed(10)
    b, h = 16, 16
    q = torch.randn(b, h, 64, generator=gen).to(cuda_device, dtype)
    k = torch.randn(b, s_max, h, 64, generator=gen).to(cuda_device, dtype)
    v = torch.randn(b, s_max, h, 64, generator=gen).to(cuda_device, dtype)
    n = torch.tensor(length, dtype=torch.int32, device=cuda_device)
    got = tdk.decode_attention(q, k, v, n)
    _assert_attention_close(got, tdr.decode_attention(q, k, v, n))


# Ranges that end mid-tile and cross from one group into the next: B 3
# over the card's whole grid (3 x 2 groups of 4,097 rows are ~47 rows a
# block), at length 1 (a block per group), 257, 4,097 and a window; the
# tensor-core pairs and the CUDA-core ones.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh,n_rep", [(64, 4), (112, 8), (128, 6), (64, 1), (112, 1)])
@pytest.mark.parametrize("length,window", [(1, None), (257, None), (4097, None), (4097, 1000)])
def test_cuda_decode_ranges_cross_groups_mid_tile(cuda_device, dtype, dh, n_rep, length, window):
    gen = torch.Generator().manual_seed(14)
    b, hkv, s_max = 3, 2, 4128
    q = torch.randn(b, hkv * n_rep, dh, generator=gen).to(cuda_device, dtype)
    k = torch.randn(b, s_max, hkv, dh, generator=gen).to(cuda_device, dtype)
    v = torch.randn(b, s_max, hkv, dh, generator=gen).to(cuda_device, dtype)
    n = torch.tensor(length, dtype=torch.int32, device=cuda_device)
    got = tdk.decode_attention(q, k, v, n, window=window)
    _assert_attention_close(got, tdr.decode_attention(q, k, v, n, window=window))


# MHA runs its heads in pairs where their count is even (a tile row holds
# two heads' slices); an odd count takes one head a group.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [64, 112])
@pytest.mark.parametrize("b,hkv,length", [(3, 3, 300), (2, 1, 4097), (2, 5, 1)])
def test_cuda_decode_mha_odd_head_counts(cuda_device, dtype, dh, b, hkv, length):
    gen = torch.Generator().manual_seed(16)
    s_max = 4128
    q = torch.randn(b, hkv, dh, generator=gen).to(cuda_device, dtype)
    k = torch.randn(b, s_max, hkv, dh, generator=gen).to(cuda_device, dtype)
    v = torch.randn(b, s_max, hkv, dh, generator=gen).to(cuda_device, dtype)
    n = torch.tensor(length, dtype=torch.int32, device=cuda_device)
    _assert_attention_close(tdk.decode_attention(q, k, v, n), tdr.decode_attention(q, k, v, n))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh,n_rep", [(64, 4), (112, 1)])
def test_cuda_decode_repeats_bitwise_and_resets_its_counters(cuda_device, dtype, dh, n_rep):
    """Two calls give equal bits (the partials merge in block order).  Calls
    back to back on one stream whose group counts differ (B 1, 7 and 3, two
    KV heads each; their groups split over many blocks) each match the
    plain version: every merging block left its counter at 0."""
    gen = torch.Generator().manual_seed(15)
    hkv, s_max = 2, 5000
    n = torch.tensor(4321, dtype=torch.int32, device=cuda_device)
    calls = []
    for b in (1, 7, 3, 1):
        q = torch.randn(b, hkv * n_rep, dh, generator=gen).to(cuda_device, dtype)
        k, v = (torch.randn(b, s_max, hkv, dh, generator=gen).to(cuda_device, dtype)
                for _ in range(2))
        calls.append(((q, k, v), tdk.decode_attention(q, k, v, n)))
    for args, got in calls:
        _assert_attention_close(got, tdr.decode_attention(*args, n))
    args, first = calls[0]
    assert torch.equal(tdk.decode_attention(*args, n), first)


def test_cuda_decode_refuses_a_pair_it_is_not_built_for(cuda_device):
    q = torch.randn(1, 5, 128, device=cuda_device)
    kv = torch.randn(1, 16, 1, 128, device=cuda_device)
    with pytest.raises(ValueError, match="supported"):
        tdk.decode_attention(q, kv, kv, torch.tensor(4, dtype=torch.int32, device=cuda_device))


# (D, F): a small ragged width, llama3.2-1b's FFN and zamba2-7b's.  T: the
# weight-streaming path (1, 4, 15, 16 rows), the tiled path just past it
# (17), off the 128-row tiles (129, 200) and several row tiles (4,100).
SWIGLU_WIDTHS = [(256, 520), (2048, 8192), (3584, 14336)]
# phi3-medium-14b's, yi-34b's and command-r-35b's FFN widths; kimi-k2's
# shared expert and qwen2-vl-2b's FFN.
SWIGLU_WIDTHS_128 = [(5120, 17920), (7168, 20480), (8192, 22528), (7168, 2048), (1536, 8960)]


def _swiglu_inputs(dev, dtype, t, d, f, seed=2):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    return (randn(t, d), randn(d, f, scale=d ** -0.5), randn(d, f, scale=d ** -0.5),
            randn(f, d, scale=f ** -0.5))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-3), (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("t", [1, 4, 15, 16, 17, 129, 200, 4100])
@pytest.mark.parametrize("d,f", SWIGLU_WIDTHS)
def test_cuda_swiglu_matches_plain(cuda_device, dtype, tol, t, d, f):
    x, wg, wu, wo = _swiglu_inputs(cuda_device, dtype, t, d, f)
    before = LAUNCHES["swiglu"]
    got = tgk.swiglu(x, wg, wu, wo)
    assert LAUNCHES["swiglu"] == before + 2
    want = tgr.swiglu(x, wg, wu, wo)
    assert got.dtype == want.dtype and got.shape == want.shape == (t, d)
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=tol, atol=tol * float(want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d,f", [(16, 2048, 8192), (4, 3584, 14336), (300, 2048, 8192)])
def test_cuda_swiglu_is_deterministic(cuda_device, dtype, t, d, f):
    """The K-split partials are summed in slice order, never by atomics:
    two runs give the same bits."""
    args = _swiglu_inputs(cuda_device, dtype, t, d, f, seed=4)
    assert torch.equal(tgk.swiglu(*args), tgk.swiglu(*args))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-3), (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("t", [4, 16, 17, 300])
@pytest.mark.parametrize("d,f", SWIGLU_WIDTHS_128)
def test_cuda_swiglu_at_the_head_dim_128_archs_widths(cuda_device, dtype, tol, t, d, f):
    """The streaming route (T <= 16) and the tiled route at the three dense
    FFN widths, kimi-k2's shared expert and qwen2-vl-2b's FFN."""
    args = _swiglu_inputs(cuda_device, dtype, t, d, f)
    got, want = tgk.swiglu(*args).float(), tgr.swiglu(*args).float()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=tol, atol=tol * float(want.abs().max()))


def test_cuda_moe_dispatch_is_deterministic_and_matches_the_cpu(cuda_device):
    """``moe_layer`` (8 experts, top-2, capacity 1.25 so pairs drop; no
    shared expert: that is the ``swiglu`` kernel, held above) under
    ``torch.use_deterministic_algorithms``: forward and
    backward on the card run (no op of the dispatch lacks a deterministic
    CUDA form), twice give the same bits, and equal the CPU's routing and
    kept pairs exactly and its output and gradients within 1e-5 of their
    largest |value| (float32; the routing products are float32 on both)."""
    import os

    from repro_torch.models.common import ModelConfig
    from repro_torch.models.ffn import moe_layer

    cfg = ModelConfig(arch="moe-test", family="moe", n_layers=1, d_model=64, n_heads=4,
                      n_kv_heads=2, d_ff=96, vocab=64, n_experts=8, top_k=2,
                      capacity_factor=1.25, dtype=torch.float32)
    gen = torch.Generator().manual_seed(7)
    d, e, f = 64, 8, 96
    cpu = {"router": torch.randn(d, e, generator=gen) * 0.3,
           "wi_gate": torch.randn(e, d, f, generator=gen) * 0.1,
           "wi_up": torch.randn(e, d, f, generator=gen) * 0.1,
           "wo": torch.randn(e, f, d, generator=gen) * 0.1}
    x = torch.randn(4, 64, d, generator=gen) + 0.3

    def run(dev):
        leaves = []

        def put(t):
            t = t.to(dev).requires_grad_()
            leaves.append(t)
            return t

        params = {k: put(v) for k, v in cpu.items()}
        xx = put(x)
        routing = {}
        out, aux = moe_layer(params, xx, cfg, routing)
        grads = torch.autograd.grad((out ** 2).mean() + 0.01 * aux, leaves)
        return out.detach(), routing, [g.cpu() for g in grads]

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        a, ra, ga = run(cuda_device)
        b, _rb, gb = run(cuda_device)
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(a, b) and all(torch.equal(p, q) for p, q in zip(ga, gb))
    c, rc, gc = run("cpu")
    assert torch.equal(ra["experts"].cpu(), rc["experts"])
    assert torch.equal(ra["kept"].cpu(), rc["kept"]) and not bool(rc["kept"].all())
    torch.testing.assert_close(a.cpu(), c, rtol=1e-5, atol=1e-5 * float(c.abs().max()))
    for p, q in zip(ga, gc):
        torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-5 * float(q.abs().max()))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3), (torch.bfloat16, 5e-2)])
def test_cuda_whisper_serve_matches_the_cpu(cuda_device, dtype, tol):
    """whisper's smoke model at the kernels' head dim (``for_kernels``:
    d_model 256, 4 heads of 64) on the card -- the encoder's and the cross
    attention's bidirectional flash, the (64, 1) decode over the self and
    the cross cache, launched as the serving rule counts them -- against
    the CPU's plain versions teacher-forced on the card's tokens, 24
    frames of ``enc_seq`` 32: logits within ``tol * (1 + |cpu|)``."""
    import dataclasses

    from repro_torch.configs import for_kernels, get_config
    from repro_torch.models import serve
    from repro_torch.models.transformer import init_params
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(for_kernels(get_config("whisper-medium", "smoke")), dtype=dtype)
    params = init_params(cfg, seed=1, device=cuda_device)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    gen = torch.Generator().manual_seed(6)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 40), generator=gen),
             "frames": torch.randn(2, 24, cfg.d_model, generator=gen).to(dtype)}
    LAUNCHES.clear()
    cache = serve.init_cache(cfg, 2, 48, device=cuda_device)
    lg, cache = serve.prefill(params, cfg, {k: v.to(cuda_device) for k, v in batch.items()},
                              cache, device=cuda_device)
    card, fed = [lg.float().cpu()], []
    for _ in range(4):
        tok = lg.argmax(-1)
        fed.append(tok.cpu())
        lg, cache = serve.decode_step(params, cfg, tok, cache, device=cuda_device)
        card.append(lg.float().cpu())
    assert LAUNCHES["flash_attention"] == cfg.enc_layers + 2 * cfg.n_layers
    assert LAUNCHES["decode_attention"] == 2 * cfg.n_layers * 4
    ccache = serve.init_cache(cfg, 2, 48, device="cpu")
    lg, ccache = serve.prefill(cpu_params, cfg, batch, ccache, device="cpu")
    host = [lg.float()]
    for tok in fed:
        lg, ccache = serve.decode_step(cpu_params, cfg, tok, ccache, device="cpu")
        host.append(lg.float())
    for a, c in zip(card, host):
        assert torch.isfinite(a).all()
        assert bool(((a - c).abs() <= tol * (1 + c.abs())).all()), float((a - c).abs().max())


@pytest.mark.parametrize("dh,theta", [(64, 500000.0), (112, 10000.0), (128, 1e6)])
def test_cuda_rope_equals_the_cpu_at_500k_positions(cuda_device, dh, theta):
    """RoPE at positions 524,224-524,287 (``long_500k``'s last), where the
    float32 angles reach ~5e5 rad: the card rotates with the CPU's
    frequency table (bitwise; a table computed on the card has entries
    one ulp apart, ~0.03 rad there) and its rotation is within 4e-7 of
    (1 + the row's largest |x|) of the CPU's."""
    from repro_torch.models.common import apply_rope, rope_frequencies

    assert torch.equal(rope_frequencies(dh, theta, device=cuda_device).cpu(),
                       rope_frequencies(dh, theta))
    gen = torch.Generator().manual_seed(dh)
    x = torch.randn((1, 64, 2, dh), generator=gen)
    pos = torch.arange(524_224, 524_288)[None]
    got = apply_rope(x.to(cuda_device), pos.to(cuda_device), theta).cpu()
    want = apply_rope(x, pos, theta)
    limit = 4e-7 * (1 + x.abs().amax(-1, keepdim=True))
    assert bool(((got - want).abs() <= limit).all()), float((got - want).abs().max())
