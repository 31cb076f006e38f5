"""The routed experts' grouped kernels (``kernels/moe_experts``) and the
choice ``models/ffn.py:moe_layer`` makes between them and the padded
``torch.bmm`` products.

On the CPU: the plain version equals ``_experts`` on every filled slot (an
empty expert, an overflowing one, a count of exactly one row tile, a partly
filled last tile), the filled-slot counts and the rows the tiles cover
against hand-worked values, and a CPU ``moe_layer`` launching no kernel.
On the card (skipped without one; this file imports no JAX): the kernels
against the ``torch.bmm`` path and the CPU's plain version within the bf16
tolerance of ``tests/test_torch_moe.py`` (2e-2 of the largest value), two
runs bit for bit, ``moe_layer`` reading no row the kernels left unwritten
(every new buffer filled with NaN first, the kernels' output among them),
and the wrapper refusing what it does not take.

    PYTHONPATH=src python -m pytest -q tests/test_torch_moe_experts.py
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from repro_torch.kernels import LAUNCHES, moe_experts
from repro_torch.kernels.moe_experts import kernel as mk, ref as mr
from repro_torch.models import ffn
from repro_torch.models.common import ModelConfig

# (run lengths of sorted pairs per expert, capacity): an empty expert, one
# past its capacity, exactly one row tile, a partly filled last tile; and a
# capacity off the row tile with a count of one.
CASES = [((0, 350, 128, 173), 300), ((1, 0, 40, 200), 200)]
D, F = 64, 96


def _counts(runs, cap):
    """The filled-slot counts ``moe_layer`` derives from the sorted pairs
    of experts with these run lengths."""
    keys = torch.cat([torch.full((n,), i) for i, n in enumerate(runs)])
    keys = keys[torch.randperm(keys.numel(), generator=torch.Generator().manual_seed(0))]
    _order, _sk, start, _rank = ffn._runs(keys, len(runs))
    return ffn._filled(start, keys.numel(), cap)


def _inputs(counts, cap, dtype, seed=3):
    """A capacity buffer [E, cap, D] whose slots past each count are zero
    rows, and the experts' weights."""
    gen = torch.Generator().manual_seed(seed)
    e = counts.numel()
    buf = torch.randn(e, cap, D, generator=gen)
    buf[torch.arange(cap)[None, :] >= counts[:, None]] = 0
    wg, wu = (torch.randn(e, D, F, generator=gen) * D ** -0.5 for _ in range(2))
    wo = torch.randn(e, F, D, generator=gen) * F ** -0.5
    return [t.to(dtype) for t in (buf, wg, wu, wo)]


def test_filled_counts_and_tile_rows_by_hand():
    """Run lengths (0, 350, 128, 173) at capacity 300: the overflowing
    expert holds 300; the tiles of 128 cover 0, 300 (three tiles cut at
    the capacity), 128 and 256 rows -- 684 of the 1,200 slots."""
    counts = _counts(*CASES[0])
    assert counts.dtype == torch.int32 and counts.tolist() == [0, 300, 128, 173]
    rows = mk.run_rows(counts, 300)
    assert rows.tolist() == [0, 300, 128, 256] and int(rows.sum()) == 684
    assert _counts(*CASES[1]).tolist() == [1, 0, 40, 200]
    assert mk.run_rows(_counts(*CASES[1]), 200).tolist() == [128, 0, 128, 200]
    assert mk.run_rows(torch.tensor([426, 5, 0]), 426).tolist() == [426, 128, 0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("runs,cap", CASES)
def test_plain_version_equals_the_bmm_experts_on_filled_slots(runs, cap, dtype):
    counts = _counts(runs, cap)
    buf, wg, wu, wo = _inputs(counts, cap, dtype)
    got, want = mr.experts(buf, wg, wu, wo, counts), ffn._experts(buf, wg, wu, wo)
    rows = mk.run_rows(counts, cap)
    for i, (n, r) in enumerate(zip(counts.tolist(), rows.tolist())):
        assert torch.equal(got[i, :n], want[i, :n]), i
        assert not got[i, n:r].any()  # the tile's zero rows
        assert not got[i, r:].any()  # tiles not run
    assert got.dtype == dtype and got.shape == buf.shape


def _layer_cfg(dtype, capacity_factor=1.25):
    return ModelConfig(arch="moe-test", family="moe", n_layers=1, d_model=D, n_heads=4,
                       n_kv_heads=2, d_ff=F, vocab=64, n_experts=8, top_k=2,
                       capacity_factor=capacity_factor, dtype=dtype)


def _layer(dtype, dev, seed=7):
    """An 8-expert top-2 layer at capacity 1.25 (pairs drop) over 4 x 256
    tokens (capacity 320 slots: past ``MIN_SLOTS``, so the card takes the
    grouped kernels), biased so some experts overflow."""
    gen = torch.Generator().manual_seed(seed)
    e = 8
    params = {"router": torch.randn(D, e, generator=gen) * 0.3,
              "wi_gate": torch.randn(e, D, F, generator=gen) * D ** -0.5,
              "wi_up": torch.randn(e, D, F, generator=gen) * D ** -0.5,
              "wo": torch.randn(e, F, D, generator=gen) * F ** -0.5}
    params["router"][:, 0] += 0.4
    x = torch.randn(4, 256, D, generator=gen) + 0.3
    return ({k: v.to(dev, dtype) for k, v in params.items()}, x.to(dev, dtype),
            _layer_cfg(dtype))


def test_cpu_moe_layer_launches_no_kernel():
    params, x, cfg = _layer(torch.bfloat16, "cpu")
    before = LAUNCHES["moe_experts"]
    routing = {}
    ffn.moe_layer(params, x, cfg, routing)
    assert LAUNCHES["moe_experts"] == before and not bool(routing["kept"].all())


# ----------------------------------------------------------------- card -- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _assert_close(got, want, tol=2e-2):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=tol, atol=tol * float(want.abs().max()))


# (run lengths, capacity, D, F) on the card: the CPU cases, and wider ones
# with several row and column tiles, a ragged K and N edge, an expert of one
# slot and one filled to the last slot of an off-tile capacity.
CUDA_CASES = [(runs, cap, D, F) for runs, cap in CASES] + [
    ((0, 700, 128, 513, 1, 256, 300, 17), 640, 512, 1032),
    ((5120, 4000, 3000, 0), 5120, 256, 512),
    ((426, 9, 300), 426, 200, 2048)]


def _card_inputs(runs, cap, d, f, dev, seed=5):
    counts = _counts(runs, cap)
    gen = torch.Generator().manual_seed(seed)
    e = counts.numel()
    buf = torch.randn(e, cap, d, generator=gen)
    buf[torch.arange(cap)[None, :] >= counts[:, None]] = 0
    wg, wu = (torch.randn(e, d, f, generator=gen) * d ** -0.5 for _ in range(2))
    wo = torch.randn(e, f, d, generator=gen) * f ** -0.5
    cpu = [t.to(torch.bfloat16) for t in (buf, wg, wu, wo)]
    return counts, cpu, [t.to(dev) for t in cpu]


@pytest.mark.parametrize("runs,cap,d,f", CUDA_CASES)
def test_cuda_grouped_experts_match_bmm_and_plain(cuda_device, runs, cap, d, f):
    counts, cpu, args = _card_inputs(runs, cap, d, f, cuda_device)
    before = LAUNCHES["moe_experts"]
    got = mk.experts(*args, counts.to(cuda_device)).cpu()
    assert LAUNCHES["moe_experts"] == before + 2
    bmm = ffn._experts(*args).cpu()
    plain = mr.experts(*cpu, counts)
    rows = mk.run_rows(counts, cap).tolist()
    for i, (n, r) in enumerate(zip(counts.tolist(), rows)):
        if n:
            _assert_close(got[i, :n], bmm[i, :n])
            _assert_close(got[i, :n], plain[i, :n])
        assert not got[i, n:r].any()  # zero rows of a run tile come out 0


@pytest.mark.parametrize("runs,cap,d,f", CUDA_CASES[2:4])
def test_cuda_grouped_experts_are_deterministic(cuda_device, runs, cap, d, f):
    """No split-K and no atomics: two runs give the same bits."""
    counts, _cpu, args = _card_inputs(runs, cap, d, f, cuda_device, seed=6)
    counts = counts.to(cuda_device)
    a, b = mk.experts(*args, counts), mk.experts(*args, counts)
    rows = mk.run_rows(counts, cap).tolist()
    for i, r in enumerate(rows):
        assert torch.equal(a[i, :r], b[i, :r])


@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
def test_cuda_moe_layer_reads_no_unwritten_row(cuda_device, capacity_factor, monkeypatch):
    """Every float ``torch.empty`` and ``torch.empty_like`` of the call --
    the kernels' output buffer among them -- filled with NaN first: the
    output's rows past each expert's run tiles are still NaN after the
    kernels, the rows inside them finite, and no NaN reaches the layer's
    output, which equals an unfilled call's bit for bit and the
    ``torch.bmm`` path's within the bf16 tolerance."""
    params, x, cfg = _layer(torch.bfloat16, cuda_device)
    cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    real_empty, real_like, real_experts = torch.empty, torch.empty_like, moe_experts.experts
    seen = []

    def nan_filled(t):
        return t.fill_(float("nan")) if t.is_floating_point() else t

    def spy(*args):
        out = real_experts(*args)
        seen.append((out.clone(), args[-1].clone()))
        return out

    with torch.no_grad():  # bf16 outside autograd: the kernels' path
        routing = {}
        want, _ = ffn.moe_layer(params, x, cfg, routing)
        with monkeypatch.context() as m:
            m.setattr(ffn, "_grouped", lambda *_a: False)
            bmm, _ = ffn.moe_layer(params, x, cfg)
        monkeypatch.setattr(torch, "empty", lambda *a, **k: nan_filled(real_empty(*a, **k)))
        monkeypatch.setattr(torch, "empty_like", lambda *a, **k: nan_filled(real_like(*a, **k)))
        monkeypatch.setattr(moe_experts, "experts", spy)
        before = LAUNCHES["moe_experts"]
        got, _ = ffn.moe_layer(params, x, cfg)
        assert LAUNCHES["moe_experts"] == before + 2
    (out, counts), = seen
    cap = out.shape[1]
    rows = mk.run_rows(counts, cap).tolist()
    for i, r in enumerate(rows):
        assert torch.isfinite(out[i, :r]).all(), i
        assert torch.isnan(out[i, r:]).all(), i
    assert sum(rows) < out.shape[0] * cap  # whole tiles left unwritten
    assert torch.isfinite(got).all() and torch.equal(got, want)
    _assert_close(got, bmm)
    assert bool(routing["kept"].all()) == (capacity_factor == 8.0)


def test_cuda_wrapper_refuses_what_it_does_not_take(cuda_device):
    counts, _cpu, (buf, wg, wu, wo) = _card_inputs(*CUDA_CASES[0], cuda_device)
    counts = counts.to(cuda_device)
    with pytest.raises(TypeError, match="bfloat16"):
        mk.experts(buf.float(), wg.float(), wu.float(), wo.float(), counts)
    with pytest.raises(TypeError, match="mixed"):
        mk.experts(buf, wg.float(), wu, wo, counts)
    with pytest.raises(ValueError, match="do not fit"):
        mk.experts(buf, wg, wu, wo[:, :8], counts)
    with pytest.raises(ValueError, match="3-D"):
        mk.experts(buf[0], wg, wu, wo, counts)
    with pytest.raises(ValueError, match="multiples of 8"):
        mk.experts(buf[..., :60].contiguous(), wg[:, :60].contiguous(), wu[:, :60].contiguous(),
                   wo[..., :60].contiguous(), counts)
    with pytest.raises(ValueError, match="contiguous"):
        mk.experts(buf.transpose(0, 1).contiguous().transpose(0, 1), wg, wu, wo, counts)
    with pytest.raises(TypeError, match="int32"):
        mk.experts(buf, wg, wu, wo, counts.long())
    with pytest.raises(ValueError, match="CUDA"):
        mk.experts(buf, wg, wu, wo, counts.cpu())
    with pytest.raises(ValueError, match="CUDA"):
        mk.experts(buf.cpu(), wg, wu, wo, counts)
