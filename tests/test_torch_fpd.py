"""The port's FPD application against the JAX package's: the pattern
helpers, ``support_counts`` / ``maximal_frequent`` and the sliding-window
detector on the same inputs, the reference's end-to-end self-loop test
through the port's engine, and FPD beside VLD as fleet tenants."""

from __future__ import annotations

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.streaming.apps import fpd as jfpd
from repro_torch.api import FleetSession, SchedulerConfig
from repro_torch.convert import fpd_config_from_reference
from repro_torch.streaming.apps.fpd import (
    FPDConfig,
    SlidingWindowState,
    _all_patterns,
    build_fpd_graph,
    candidate_patterns,
    maximal_frequent,
    pack_itemset,
    random_transaction,
    support_counts,
)

CPU = torch.device("cpu")


def _t(masks):
    return torch.as_tensor(np.asarray(masks, dtype=np.int64))


@pytest.mark.parametrize("n_items,size", [(8, 2), (12, 3), (32, 3)])
def test_patterns_and_candidates_equal_the_reference(n_items, size):
    np.testing.assert_array_equal(_all_patterns(n_items, size), jfpd._all_patterns(n_items, size))
    jcfg = jfpd.FPDConfig(n_items=n_items, max_pattern_size=size)
    cfg = fpd_config_from_reference(jcfg)
    rng = np.random.default_rng(n_items)
    for _ in range(20):
        mask = random_transaction(cfg, rng)
        np.testing.assert_array_equal(candidate_patterns(mask, cfg),
                                      jfpd.candidate_patterns(mask, jcfg))
    assert pack_itemset([0, 5, 31]) == jfpd.pack_itemset([0, 5, 31])


def test_random_transactions_equal_the_reference():
    jcfg = jfpd.FPDConfig(n_items=32)
    cfg = fpd_config_from_reference(jcfg)
    a, b = np.random.default_rng(4), np.random.default_rng(4)
    assert [random_transaction(cfg, a) for _ in range(200)] == \
        [jfpd.random_transaction(jcfg, b) for _ in range(200)]


@pytest.mark.parametrize("n_items,size,threshold", [(12, 3, 6), (32, 2, 10)])
def test_support_counts_and_maximal_frequent_equal_the_reference(n_items, size, threshold):
    cfg = FPDConfig(n_items=n_items, max_pattern_size=size)
    pats = _all_patterns(n_items, size)
    rng = np.random.default_rng(7)
    window = np.array([random_transaction(cfg, rng) for _ in range(300)], dtype=np.uint32)
    counts = support_counts(_t(pats), _t(window))
    want = jfpd.support_counts(jnp.asarray(pats), jnp.asarray(window))
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want))
    mfp = maximal_frequent(_t(pats), counts, threshold)
    want_mfp = jfpd.maximal_frequent(jnp.asarray(pats), want, jnp.int32(threshold))
    np.testing.assert_array_equal(mfp.numpy(), np.asarray(want_mfp))
    assert mfp.any()


def test_pack_and_candidates():
    cfg = FPDConfig(n_items=8, max_pattern_size=2)
    cands = candidate_patterns(pack_itemset([1, 3, 5]), cfg)
    assert len(cands) == 6
    assert pack_itemset([1, 3]) in cands
    assert pack_itemset([1, 3, 5]) not in cands


def test_support_counts_basic():
    pats = _t([pack_itemset([0]), pack_itemset([1]), pack_itemset([0, 1])])
    window = _t([pack_itemset([0, 1]), pack_itemset([0]), pack_itemset([0, 1, 2])])
    np.testing.assert_array_equal(support_counts(pats, window).numpy(), [3, 2, 2])


def test_maximal_frequent_definition():
    pats = _t([pack_itemset([0]), pack_itemset([1]), pack_itemset([0, 1]), pack_itemset([2])])
    counts = torch.tensor([10, 9, 8, 3], dtype=torch.int32)
    np.testing.assert_array_equal(maximal_frequent(pats, counts, 5).numpy(),
                                  [False, False, True, False])


def test_sliding_window_state_machine():
    cfg = FPDConfig(n_items=6, max_pattern_size=2, window=4, support_threshold=3)
    st = SlidingWindowState(cfg, device=CPU)
    m = pack_itemset([0, 1])
    changed_total = []
    for _ in range(3):
        changed_total += st.apply(m, entering=True)
    assert len(changed_total) > 0
    assert pack_itemset([0, 1]) in st.current_mfps()
    for _ in range(4):
        st.apply(pack_itemset([2]), entering=True)
    idx = int(np.nonzero(st.patterns == np.uint32(m))[0][0])
    assert st.counts_host()[idx] < 3
    assert m not in st.current_mfps()


def test_window_eviction_keeps_counts_nonnegative():
    cfg = FPDConfig(n_items=5, max_pattern_size=2, window=8, support_threshold=2)
    st = SlidingWindowState(cfg, device=CPU)
    rng = np.random.default_rng(3)
    for _ in range(50):
        st.apply(random_transaction(cfg, rng), entering=True)
    assert (st.counts_host() >= 0).all()
    assert len(st.window) <= cfg.window
    recount = support_counts(st.patterns_dev, _t(list(st.window)))
    np.testing.assert_array_equal(st.counts_host(), recount.numpy())


def _event_stream(cfg, n, seed):
    """A seeded stream of enter events with some leave events (of a mask in
    the window, or of one that is not) mixed in."""
    rng = np.random.default_rng(seed)
    events, recent = [], []
    for _ in range(n):
        u = rng.random()
        if u < 0.15 and recent:
            events.append((recent[int(rng.integers(len(recent)))], False))
        elif u < 0.18:
            events.append((random_transaction(cfg, rng), False))
        else:
            mask = random_transaction(cfg, rng)
            recent = (recent + [mask])[-cfg.window:]
            events.append((mask, True))
    return events


def test_detector_stream_equals_the_reference():
    """A seeded 2,000-event stream: the same ``changed`` lists after every
    event and the same counts, MFP flags and window at the end."""
    jcfg = jfpd.FPDConfig(n_items=12, max_pattern_size=3, window=64, support_threshold=6)
    cfg = fpd_config_from_reference(jcfg)
    mine, ref = SlidingWindowState(cfg, device=CPU), jfpd.SlidingWindowState(jcfg)
    flips = 0
    for i, (mask, entering) in enumerate(_event_stream(cfg, 2000, seed=11)):
        got, want = mine.apply(mask, entering), ref.apply(mask, entering)
        assert got == want, i
        flips += len(got)
    assert flips > 100
    np.testing.assert_array_equal(mine.counts_host(), ref.counts)
    np.testing.assert_array_equal(mine.mfp_np, ref.mfp)
    assert list(mine.window) == list(ref.window)
    np.testing.assert_array_equal(mine.current_mfps(), ref.current_mfps())


def test_engine_fpd_end_to_end_with_self_loop():
    """The reference's self-loop test through the port's engine on the CPU:
    the loop is a typed edge, MFP changes are reported, the hot pattern is
    maximal-frequent."""
    cfg = FPDConfig(n_items=8, max_pattern_size=2, window=16, support_threshold=4)
    graph, state, reports = build_fpd_graph(cfg, device=CPU)
    assert graph.routing_matrix()[1][1] == pytest.approx(0.3)
    session = graph.bind("engine", device=CPU)
    session.start({"generate": 1, "detect": 1, "report": 1})
    rng = np.random.default_rng(6)
    hot = pack_itemset([0, 1])
    for i in range(24):
        session.inject((hot if i % 2 == 0 else random_transaction(cfg, rng), True))
    assert session.drain(timeout=30.0)
    session.stop()
    assert len(reports) > 0
    assert hot in state.current_mfps()
    recount = support_counts(state.patterns_dev, _t(list(state.window)))
    np.testing.assert_array_equal(state.counts_host(), recount.numpy())


def test_fpd_beside_vld_as_fleet_tenants():
    """FPD and VLD as live engine tenants of one batched fleet on the CPU:
    planned, started, fed, ticked, stopped; every plan within the pool.  No
    timing is asserted (wall-clock windows)."""
    from repro_torch.streaming.apps.vld import VLDConfig, build_vld_graph, logo_library, make_frame

    vcfg = VLDConfig(height=32, width=32, max_keypoints=16, n_logos=4)
    lib = logo_library(vcfg)
    vgraph, detections = build_vld_graph(vcfg, lib, fps=4.0, device=CPU)
    fcfg = FPDConfig(n_items=10, max_pattern_size=2, window=64, support_threshold=8)
    fgraph, state, _reports = build_fpd_graph(fcfg, rate=4.0, device=CPU)
    fleet = FleetSession(
        {"vld": vgraph.bind("engine", config=SchedulerConfig(t_max=2.0), device=CPU),
         "fpd": fgraph.bind("engine", config=SchedulerConfig(t_max=4.0), device=CPU)},
        k_max=16, solver="batched", device=CPU,
    )
    rng = np.random.default_rng(2)
    try:
        ks = fleet.start()
        assert sum(sum(v.values()) for v in ks.values()) <= 16
        t0 = time.perf_counter()
        frames = 0
        while time.perf_counter() - t0 < 0.6:
            fleet.sessions["vld"].inject(make_frame(vcfg, rng, lib, rng.random() < 0.5))
            frames += 1
            for _ in range(4):
                fleet.sessions["fpd"].inject((random_transaction(fcfg, rng), True))
            time.sleep(0.02)
        for _ in range(2):
            d = fleet.tick()
            # A loaded host measures slow service: the minima may then pass
            # the pool ("infeasible"), which keeps the split in force.
            assert d.action in ("none", "rebalance", "overloaded", "infeasible")
            assert d.plan is None or d.plan.total <= d.k_max
            assert sum(sum(v.values()) for v in fleet.allocations().values()) <= 16
        assert all(s.drain(timeout=30.0) for s in fleet.sessions.values())
    finally:
        fleet.stop()
    assert len(detections) == frames
    recount = support_counts(state.patterns_dev, _t(list(state.window)))
    np.testing.assert_array_equal(state.counts_host(), recount.numpy())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def test_cuda_detector_equals_the_cpu(cuda_device):
    """At the paper's vocabulary (32 items, patterns up to 3: P = 5,488) the
    detector on the card gives the CPU's changed lists and counts."""
    cfg = FPDConfig(n_items=32, max_pattern_size=3, window=200, support_threshold=12)
    card, host = SlidingWindowState(cfg, device=cuda_device), SlidingWindowState(cfg, device=CPU)
    for mask, entering in _event_stream(cfg, 600, seed=5):
        assert card.apply(mask, entering) == host.apply(mask, entering)
    np.testing.assert_array_equal(card.counts_host(), host.counts_host())
