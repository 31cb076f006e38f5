"""The port's VLD application against the JAX package's.

The same seeded numpy frames go through ``repro.streaming.apps.vld`` and
``repro_torch.streaming.apps.vld`` (on the CPU, where the matcher takes
the plain ``l2_match`` version), at the default ``VLDConfig`` and at a
120 x 160 one.  The blur sums its taps in another order than XLA's
convolution, so DoG responses differ in the last ulp: keypoint choice and
order must still be equal, descriptors agree to atol 1e-5 (padded entries
included), and match counts and detections are equal.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.streaming.apps import vld as J
from repro_torch.convert import vld_from_reference
from repro_torch.streaming.apps import vld as T

CONFIGS = [{}, {"height": 120, "width": 160}]


def _jax_keypoints(frame, cfg):
    """The reference extractor's keypoint choice, step for step (its
    ``extract_features`` returns only descriptors and the mask)."""
    dog = jnp.abs(J._blur(frame, cfg.dog_sigma1) - J._blur(frame, cfg.dog_sigma2))
    pad = jnp.pad(dog, 1, constant_values=jnp.inf)
    neigh = jnp.stack([pad[1 + dy:1 + dy + dog.shape[0], 1 + dx:1 + dx + dog.shape[1]]
                       for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)])
    is_max = (dog >= neigh.max(axis=0)) & (dog > cfg.response_floor)
    half = cfg.patch // 2
    border = jnp.zeros_like(is_max).at[half:-half, half:-half].set(True)
    score = jnp.where(is_max & border, dog, -jnp.inf)
    return np.asarray(jnp.argsort(score.ravel())[::-1][: cfg.max_keypoints])


def _setup(kw):
    jcfg = J.VLDConfig(**kw)
    jlib = J.logo_library(jcfg)
    cfg, lib = vld_from_reference(jcfg, jlib)
    return jcfg, jlib, cfg, lib


def _frames(jcfg, lib, n, seed):
    rng = np.random.default_rng(seed)
    return [J.make_frame(jcfg, rng, lib, i % 2 == 0) for i in range(n)]


@pytest.mark.parametrize("kw", CONFIGS)
def test_config_library_and_frames_carry_across(kw):
    jcfg, jlib, cfg, lib = _setup(kw)
    assert cfg == T.VLDConfig(**kw)
    np.testing.assert_array_equal(lib, np.asarray(jlib))
    np.testing.assert_array_equal(lib, T.logo_library(cfg))
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    for with_logo in (True, False, True):
        np.testing.assert_array_equal(T.make_frame(cfg, r1, lib, with_logo),
                                      J.make_frame(jcfg, r2, lib, with_logo))


@pytest.mark.parametrize("kw", CONFIGS)
def test_extract_features_matches_jax(kw):
    jcfg, _, cfg, lib = _setup(kw)
    for frame in _frames(jcfg, lib, 8, seed=21):
        jdesc, jvalid = J.extract_features(jnp.asarray(frame), jcfg)
        flat, valid = T.keypoints(torch.from_numpy(frame), cfg)
        desc, valid2 = T.extract_features(torch.from_numpy(frame), cfg)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        np.testing.assert_array_equal(valid2.numpy(), np.asarray(jvalid))
        np.testing.assert_array_equal(flat.numpy(), _jax_keypoints(jnp.asarray(frame), jcfg))
        assert desc.dtype == torch.float32 and desc.shape == (cfg.max_keypoints, cfg.patch**2)
        np.testing.assert_allclose(desc.numpy(), np.asarray(jdesc), rtol=0, atol=1e-5)
        assert 0 < int(valid.sum()) <= cfg.max_keypoints


@pytest.mark.parametrize("kw", CONFIGS)
def test_match_counts_and_detections_match_jax(kw):
    jcfg, jlib, cfg, lib = _setup(kw)
    tlib = torch.from_numpy(lib)
    fired = 0
    for frame in _frames(jcfg, lib, 32, seed=33):
        jdesc, jvalid = J.extract_features(jnp.asarray(frame), jcfg)
        jcounts = J.match_features(jdesc, jvalid, jlib, jcfg.match_threshold)
        jdet = np.asarray(J.aggregate_matches(jcounts, jcfg.n_logos, jcfg.descriptors_per_logo,
                                              jcfg.detect_threshold))
        desc, valid = T.extract_features(torch.from_numpy(frame), cfg)
        counts = T.match_features(desc, valid, tlib, cfg.match_threshold)
        det = T.aggregate_matches(counts, cfg.n_logos, cfg.descriptors_per_logo,
                                  cfg.detect_threshold)
        assert counts.dtype == torch.int32
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
        np.testing.assert_array_equal(det.numpy(), jdet)
        fired += int(jdet.any())
    assert fired >= 8  # half the frames carry a logo; most of them are found


def test_build_vld_graph_topology_matches_jax():
    jcfg, jlib, cfg, lib = _setup({})
    jgraph, _ = J.build_vld_graph(jcfg, jlib)
    graph, detections = T.build_vld_graph(cfg, lib, device="cpu")
    assert graph.names == jgraph.names == ["extract", "match", "aggregate"]
    np.testing.assert_array_equal(graph.routing_matrix(), jgraph.routing_matrix())
    np.testing.assert_array_equal(graph.lam0_vector(), jgraph.lam0_vector())
    assert graph.arrival_kind == jgraph.arrival_kind == "uniform"
    assert [op.mu for op in graph.ops] == [op.mu for op in jgraph.ops]
    assert graph.source_names == jgraph.source_names == ["extract"]
    assert all(op.fn is not None for op in graph.ops) and detections == []


def test_operators_chain_the_pipeline_on_the_cpu():
    jcfg, jlib, cfg, lib = _setup({})
    ops, detections = T.build_vld_operators(cfg, lib, device="cpu")
    by_name = {op.name: op for op in ops}
    frame = _frames(jcfg, lib, 1, seed=2)[0]
    [(dst, payload)] = by_name["extract"].fn(frame)
    assert dst == "match"
    [(dst, counts)] = by_name["match"].fn(payload)
    assert dst == "aggregate" and counts.shape == (cfg.n_logos * cfg.descriptors_per_logo,)
    assert by_name["aggregate"].fn(counts) == []
    jdesc, jvalid = J.extract_features(jnp.asarray(frame), jcfg)
    want = J.aggregate_matches(J.match_features(jdesc, jvalid, jlib, jcfg.match_threshold),
                               jcfg.n_logos, jcfg.descriptors_per_logo, jcfg.detect_threshold)
    np.testing.assert_array_equal(detections[0], np.asarray(want))
