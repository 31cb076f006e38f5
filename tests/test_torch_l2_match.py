"""The port's l2_match kernels against the JAX package.

The plain PyTorch versions (``repro_torch/kernels/l2_match/ref.py``, what
the dispatch runs for CPU tensors) are held against the JAX package's jnp
reference and its Pallas kernels in interpret mode, on the same seeded
numpy inputs.  Distances agree to rtol 1e-5: the port sums the cross term
and the norms over D in order (the CUDA kernel's order), XLA in its own.
Counts agree exactly on data kept away from the threshold; one test pins
down the one-ulp window where the two JAX routes disagree.  The CUDA
kernels run only on a card (``test_cuda_l2_kernels_match_plain_versions``
skips here; ``chip_smoke.py`` runs the same check).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.l2_match import kernel as jk, ref as jr
from repro_torch.kernels import _build
from repro_torch.kernels.l2_match import kernel as tk, ops as to, ref as tr


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _pad_rows(x, block=128):
    return np.pad(x, ((0, (-x.shape[0]) % block),) + ((0, 0),) * (x.ndim - 1))


def _pallas_pairwise(a, b):
    out = jk.pairwise_sq_l2_pallas(jnp.asarray(_pad_rows(a)), jnp.asarray(_pad_rows(b)),
                                   interpret=True)
    return np.asarray(out)[: a.shape[0], : b.shape[0]]


def _pallas_count(a, b, valid, threshold):
    out = jk.match_count_pallas(jnp.asarray(_pad_rows(a)), jnp.asarray(_pad_rows(b)),
                                jnp.asarray(_pad_rows(valid)), threshold, interpret=True)
    return np.asarray(out)[: b.shape[0]]


def _descriptors(m, n, d, seed):
    """Unit-norm rows; every third query is a noisy copy of a library row,
    so a 0.8 threshold fires.  Returns (a, b, valid)."""
    rng = np.random.default_rng(seed)
    b = rng.normal(size=(n, d))
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    a = rng.normal(size=(m, d))
    near = np.arange(0, m, 3)
    a[near] = b[rng.integers(0, n, len(near))] * 8.0 + rng.normal(size=(len(near), d)) * 0.5
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    valid = rng.random(m) < 0.7
    return a.astype(np.float32), b.astype(np.float32), valid


SHAPES = [(128, 128, 64), (256, 128, 64), (100, 77, 50), (130, 129, 33), (1, 3, 64)]


@pytest.mark.parametrize("m,n,d", SHAPES)
def test_pairwise_plain_matches_jax_ref_and_pallas(m, n, d):
    a, b, _ = _descriptors(m, n, d, seed=m + n + d)
    got = tr.pairwise_sq_l2(_t(a), _t(b)).numpy()
    assert got.dtype == np.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got, np.asarray(jr.pairwise_sq_l2(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, _pallas_pairwise(a, b), rtol=1e-5, atol=1e-6)


def _away_from_threshold(a, b, threshold, margin=1e-4):
    d2 = ((a.astype(np.float64)[:, None, :] - b.astype(np.float64)[None]) ** 2).sum(-1)
    return np.abs(d2 - threshold**2).min() > margin


@pytest.mark.parametrize("m,n,d", SHAPES)
@pytest.mark.parametrize("with_mask", [True, False])
def test_match_count_plain_equals_jax_exactly(m, n, d, with_mask):
    a, b, valid = _descriptors(m, n, d, seed=7 * m + n + d)
    thr = 0.8
    assert _away_from_threshold(a, b, thr)
    got = tr.match_count(_t(a), _t(b), thr, _t(valid) if with_mask else None).numpy()
    want = np.asarray(jr.match_count(jnp.asarray(a), jnp.asarray(b), thr,
                                     jnp.asarray(valid) if with_mask else None))
    assert got.dtype == np.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got, want)
    mask = valid if with_mask else np.ones(m, dtype=bool)
    np.testing.assert_array_equal(got, _pallas_count(a, b, mask, thr))
    if m > 3:
        assert got.sum() > 0  # the threshold fires


def test_threshold_boundary_window():
    """One distance at 0.64000005, the float32 value of f32(0.8)**2.  The
    Pallas kernel squares the threshold in float32 and counts it; the jnp
    reference squares in double and rounds once (t2 = f32(0.64) =
    0.63999999) and does not.  The port follows the reference in both its
    faces (the CUDA kernel gets the same ``squared_threshold``)."""
    d = 64
    a = np.zeros((3, d), np.float32)
    a[0, 0] = np.float32(0.8)  # d2 = f32(0.8)**2 = 0.64000005
    a[1, 0] = np.float32(0.7)  # inside either way
    a[2, 0] = np.float32(0.9)  # outside either way
    b = np.zeros((1, d), np.float32)
    d2 = tr.pairwise_sq_l2(_t(a), _t(b)).numpy()[:, 0]
    assert d2[0] == np.float32(0.8) ** 2 == np.float32(0.64000005)
    assert np.float32(0.64) < d2[0]
    assert tr.squared_threshold(0.8) == float(np.float32(0.64))
    valid = np.ones(3, dtype=bool)
    assert _pallas_count(a, b, valid, 0.8).tolist() == [2]  # squares in float32
    assert np.asarray(jr.match_count(jnp.asarray(a), jnp.asarray(b), 0.8)).tolist() == [1]
    assert tr.match_count(_t(a), _t(b), 0.8).tolist() == [1]
    assert to.match_count(_t(a), _t(b), 0.8, _t(valid)).tolist() == [1]


def test_ops_send_cpu_tensors_to_the_plain_versions():
    before = dict(_build.LAUNCHES)
    a, b, valid = _descriptors(40, 30, 16, seed=1)
    np.testing.assert_array_equal(to.pairwise_sq_l2(_t(a), _t(b)).numpy(),
                                  tr.pairwise_sq_l2(_t(a), _t(b)).numpy())
    np.testing.assert_array_equal(to.match_count(_t(a), _t(b), 0.8, _t(valid)).numpy(),
                                  tr.match_count(_t(a), _t(b), 0.8, _t(valid)).numpy())
    assert dict(_build.LAUNCHES) == before  # no kernel launch on the CPU


@pytest.mark.parametrize("call", [
    lambda x: tk.pairwise_sq_l2(x, x),
    lambda x: tk.match_count(x, x, 0.8),
])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    with pytest.raises(ValueError, match="CUDA"):
        call(torch.ones(4, 8, dtype=torch.float32))


def test_kernel_wrappers_check_shapes():
    with pytest.raises(ValueError, match=r"a \[M, D\] and b \[N, D\]"):
        tk.pairwise_sq_l2(torch.ones(4, 8), torch.ones(4, 7))


@pytest.mark.parametrize("d,aligned,want", [
    (64, True, True),  # the VLD matcher: 16-byte copies
    (64, False, False),  # an unaligned base: 4-byte copies
    (50, True, False),  # D % 4 != 0: 4-byte copies
    (100, True, True),
    (3, True, False),
    (1, False, False),
])
def test_match_count_plan_picks_copy_path(d, aligned, want):
    assert tk.plan(d, aligned) is want


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("m,n,d", [(1024, 1024, 64), (1000, 777, 50)])
def test_cuda_l2_kernels_match_plain_versions(cuda_device, m, n, d):
    a, b, valid = (_t(x).to(cuda_device) for x in _descriptors(m, n, d, seed=3))
    assert torch.equal(tk.pairwise_sq_l2(a, b), tr.pairwise_sq_l2(a, b))
    assert torch.equal(tk.match_count(a, b, 0.8, valid), tr.match_count(a, b, 0.8, valid))


def _card_operands(m, n, d, seed, dev):
    if m and n:
        a, b, valid = _descriptors(m, n, d, seed)
    else:
        rng = np.random.default_rng(seed)
        a, b = (rng.normal(size=(r, d)).astype(np.float32) for r in (m, n))
        valid = rng.random(m) < 0.7
    return (_t(x).to(dev) for x in (a, b, valid))


def _unaligned(x):
    """A contiguous copy of ``x`` whose data starts 4 bytes past a 16-byte
    boundary."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.parametrize("m,n,d", [(300, 200, d) for d in (1, 3, 50, 64, 100)]
                         + [(0, 64, 64), (64, 0, 64), (130, 70, 0)])
def test_cuda_match_count_matches_plain_bitwise(cuda_device, m, n, d):
    a, b, valid = _card_operands(m, n, d, seed=m + n + d, dev=cuda_device)
    assert torch.equal(tk.match_count(a, b, 0.8, valid), tr.match_count(a, b, 0.8, valid))
    none = torch.zeros_like(valid)
    assert torch.equal(tk.match_count(a, b, 0.8, none), torch.zeros(n, dtype=torch.int32,
                                                                    device=cuda_device))


@pytest.mark.parametrize("m,n,d", [(1024, 1024, 64), (1000, 777, 64)])
@pytest.mark.parametrize("aligned", [True, False])
def test_cuda_match_count_every_copy_path_matches_plain(cuda_device, m, n, d, aligned):
    """16-byte copies and (bases 4 bytes off a 16-byte boundary) 4-byte
    ones, at the VLD shape and a ragged one."""
    a, b, valid = _card_operands(m, n, d, seed=m + n, dev=cuda_device)
    if not aligned:
        a, b = _unaligned(a), _unaligned(b)
    assert tk.plan(d, a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0) is aligned
    assert torch.equal(tk.match_count(a, b, 0.8, valid), tr.match_count(a, b, 0.8, valid))


@pytest.mark.parametrize("m,n,d", [(1024, 1024, 64), (1000, 777, 50), (300, 200, 1),
                                   (300, 200, 3), (65, 63, 100), (0, 64, 64), (64, 0, 64),
                                   (130, 70, 0)])
@pytest.mark.parametrize("aligned", [True, False])
def test_cuda_pairwise_sq_l2_matches_plain_bitwise(cuda_device, m, n, d, aligned):
    """The register tile's store epilogue on both copy paths, ragged tile
    edges, a depth tail, and empty operands."""
    a, b, _valid = _card_operands(m, n, d, seed=m + n + d, dev=cuda_device)
    if not aligned:
        a, b = _unaligned(a), _unaligned(b)
    got = tk.pairwise_sq_l2(a, b)
    assert got.shape == (m, n)
    assert torch.equal(got, tr.pairwise_sq_l2(a, b))
