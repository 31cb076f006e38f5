"""The port's live control loop against the JAX package's.

* the measurer: the same probe events and ``pull(now)`` times give equal
  snapshots;
* the scheduler: ``DRSScheduler.tick_from`` (and ``decide_single`` under
  it) gives bitwise-equal actions, allocations, budgets and E[T] on seeded
  snapshots, through every branch -- rebalance, none, overloaded,
  infeasible, scale_out / scale_in with a ``Negotiator``, and the straggler
  ``rebalance_hint`` -- with both allocators;
* the session: a short live VLD run on the CPU through
  ``DRSSession.bind(graph, "engine", device="cpu")`` detects exactly what
  the JAX package's offline pipeline detects, frame by frame.
"""

from __future__ import annotations

import math
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import allocator as jalloc
from repro.core import controller as jctl
from repro.core.jackson import OperatorSpec as JSpec, Topology as JTopology
from repro.core.measurer import Measurer as JMeasurer, MeasurementSnapshot as JSnap
from repro.core.negotiator import (
    Machine as JMachine, Negotiator as JNegotiator, ResourcePool as JPool,
)
from repro.core.scheduler import DRSScheduler as JScheduler, SchedulerConfig as JConfig
from repro.streaming.apps import vld as JV
from repro_torch.api.graph import AppGraph, GraphValidationError
from repro_torch.api.session import DRSSession, SchedulerConfig
from repro_torch.convert import vld_from_reference
from repro_torch.core import allocator as talloc
from repro_torch.core import controller as tctl
from repro_torch.core.jackson import OperatorSpec, Topology
from repro_torch.core.measurer import Measurer, MeasurementSnapshot
from repro_torch.core.negotiator import Machine, Negotiator, ResourcePool
from repro_torch.core.scheduler import DRSScheduler
from repro_torch.kernels import _build
from repro_torch.streaming.apps import vld as TV
from repro_torch.streaming.engine import Operator, StreamEngine


def _same(x, y):
    """Equal, with NaN equal to NaN (floats compared exactly)."""
    if isinstance(x, dict):
        return x.keys() == y.keys() and all(_same(x[k], y[k]) for k in x)
    if isinstance(x, (list, tuple)):
        return len(x) == len(y) and all(_same(a, b) for a, b in zip(x, y))
    if isinstance(x, float) or isinstance(y, float):
        return (math.isnan(x) and math.isnan(y)) or x == y
    return x == y


def _snap_dict(s):
    return {"lam": s.lam_hat.tolist(), "mu": s.mu_hat.tolist(), "lam0": float(s.lam0_hat),
            "soj": float(s.sojourn_hat), "t": s.t, "drop": s.drop_hat.tolist()}


# --------------------------------------------------------------------------- #
# measurer
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("smoother,kw", [("ewma", {"alpha": 0.6}), ("window", {"w": 3})])
def test_measurer_gives_the_reference_snapshots(smoother, kw):
    names = ["a", "b", "c"]
    ms = [cls(names, n_m=4, smoother=smoother, smoother_kw=kw) for cls in (JMeasurer, Measurer)]
    probes = [{n: [m.new_probe(n) for _ in range(2 if n == "b" else 1)] for n in names}
              for m in ms]
    rng = np.random.default_rng(8)
    now = 100.0
    for m in ms:
        m.pull(now)
    for _ in range(6):
        events = []
        for _ in range(200):
            op = names[rng.integers(3)]
            inst = int(rng.integers(len(probes[0][op])))
            kind = rng.choice(["enqueue", "processed", "dropped", "external", "complete"],
                              p=[0.35, 0.35, 0.05, 0.15, 0.1])
            events.append((op, inst, kind, float(rng.exponential(0.01)), int(rng.integers(1, 3))))
        now += float(rng.uniform(0.5, 2.0))
        snaps = []
        for m, pr in zip(ms, probes):
            for op, inst, kind, x, n in events:
                p = pr[op][inst]
                if kind == "enqueue":
                    p.on_enqueue(n)
                elif kind == "processed":
                    p.on_processed(x, n)
                elif kind == "dropped":
                    p.on_dropped(n)
                elif kind == "external":
                    m.on_external_arrival(n)
                else:
                    m.on_tuple_complete(x, n)
            snaps.append(m.pull(now))
        assert _same(_snap_dict(snaps[0]), _snap_dict(snaps[1]))
        assert _same(ms[0].last_instance_mu, ms[1].last_instance_mu)
        assert snaps[0].complete() == snaps[1].complete()


# --------------------------------------------------------------------------- #
# scheduler / decide_single
# --------------------------------------------------------------------------- #
NAMES = ["extract", "match", "aggregate"]
CHAIN = np.array([[0, 1.0, 0], [0, 0, 1.0], [0, 0, 0]])


def _pair(k0, cfg_kw, *, machines=None, leased=0, routing=CHAIN, names=NAMES):
    """The reference scheduler and the port's, built alike (with a
    negotiator over identical pools when ``machines`` is given)."""
    out = []
    for sched_cls, cfg_cls, pool_cls, mach_cls, neg_cls in (
        (JScheduler, JConfig, JPool, JMachine, JNegotiator),
        (DRSScheduler, SchedulerConfig, ResourcePool, Machine, Negotiator),
    ):
        neg = None
        if machines is not None:
            pool = pool_cls([mach_cls(f"m{i}", p) for i, p in enumerate(machines)])
            for i in range(leased):
                pool.lease(f"m{i}")
            neg = neg_cls(pool)
        out.append(sched_cls(names, routing, np.asarray(k0), cfg_cls(**cfg_kw), negotiator=neg))
    return out


def _tick_both(pair, lam, mu, lam0, *, drop=None, soj=0.01, t=10.0):
    ds = []
    for sched, snap_cls in zip(pair, (JSnap, MeasurementSnapshot)):
        ds.append(sched.tick_from(snap_cls.from_rates(lam, mu, lam0, soj, t, drop_hat=drop), t))
    a, b = ds
    assert _same(a.as_dict(), b.as_dict()), (a.as_dict(), b.as_dict())
    assert (a.plan is None) == (b.plan is None)
    if a.plan is not None:
        for f in ("k_old", "k_new"):
            np.testing.assert_array_equal(getattr(a.plan, f), getattr(b.plan, f))
        for f in ("pause_seconds", "migration_seconds", "backlog_drain_seconds",
                  "benefit_per_second"):
            assert getattr(a.plan, f) == getattr(b.plan, f)
    np.testing.assert_array_equal(pair[0].k_current, pair[1].k_current)
    return b


LIVE = dict(k_max=6, min_improvement=0.01, horizon_seconds=600.0)


@pytest.mark.parametrize("allocator", ["table", "heap"])
@pytest.mark.parametrize("case", [
    # (k0, config, lam, mu, lam0, drop, expected action)
    ([1, 2, 1], LIVE, [200.0, 200.0, 200.0], [240.0, 2650.0, 2600.0], 200.0, None, "rebalance"),
    ([1, 2, 1], LIVE, [86.0, 86.0, 86.0], [240.0, 2650.0, 2600.0], 86.0, None, "none"),
    ([3, 1, 2], LIVE, [86.0, 86.0, 86.0], [240.0, 2650.0, 2600.0], 86.0, None, "none"),
    ([1, 2, 1], LIVE, [300.0, 260.0, 260.0], [240.0, 2650.0, 2600.0], 300.0, None,
     "overloaded"),
    ([2, 2, 2], LIVE, [100.0, 100.0, 100.0], [240.0, 2650.0, 2600.0], 100.0,
     [0.0, 0.0, 60.0], "overloaded"),
    ([3, 1, 1], dict(LIVE, k_max=4), [500.0, 500.0, 500.0], [240.0, 2650.0, 2600.0], 500.0,
     None, "infeasible"),
    ([1, 1, 1], dict(LIVE, k_max=12, t_max=0.02), [30.0, 60.0, 60.0], [40.0, 100.0, 500.0],
     30.0, None, "rebalance"),
])
def test_scheduler_ticks_equal_the_reference(case, allocator):
    k0, cfg, lam, mu, lam0, drop, action = case
    pair = _pair(k0, dict(cfg, allocator=allocator))
    d = _tick_both(pair, lam, mu, lam0, drop=drop)
    assert d.action == action


@pytest.mark.parametrize("allocator", ["table", "heap"])
def test_negotiated_scale_out_then_scale_in_equal_the_reference(allocator):
    cfg = dict(t_max=0.05, min_improvement=0.01, allocator=allocator)
    pair = _pair([2, 2, 2], cfg, machines=[2] * 12, leased=3)
    d = _tick_both(pair, [60.0, 120.0, 120.0], [40.0, 100.0, 500.0], 60.0)
    assert d.action == "scale_out"
    assert pair[1].negotiator.k_max == pair[0].negotiator.k_max > 6
    d = _tick_both(pair, [5.0, 10.0, 10.0], [40.0, 100.0, 500.0], 5.0, t=20.0)
    assert d.action == "scale_in"
    assert pair[1].negotiator.k_max == pair[0].negotiator.k_max


def test_straggler_hint_equals_the_reference():
    pair = _pair([3, 1, 2], LIVE)
    for sched in pair:
        for rnd in range(3):
            for idx, rate in enumerate([240.0, 250.0, 60.0]):
                sched.straggler_detector.observe("extract", idx, rate + rnd)
    d = _tick_both(pair, [86.0, 86.0, 86.0], [240.0, 2650.0, 2600.0], 86.0)
    assert d.action == "rebalance_hint" and d.stragglers == (("extract", 2),)


def test_random_snapshots_equal_the_reference():
    """Seeded sweep over a fan-out graph with a feedback edge, both
    allocators, with and without T_max."""
    names = ["src", "a", "b", "sink"]
    routing = np.array([[0, 1.5, 0.5, 0], [0, 0, 0, 1.0], [0, 0.3, 0, 0.7], [0, 0, 0, 0]])
    rng = np.random.default_rng(17)
    actions = set()
    for trial in range(24):
        cfg = dict(k_max=int(rng.integers(6, 20)),
                   t_max=None if trial % 3 == 0 else float(rng.uniform(0.05, 0.5)),
                   min_improvement=float(rng.choice([0.0, 0.01, 0.05])),
                   horizon_seconds=float(rng.choice([60.0, 600.0])),
                   allocator=("table", "heap")[trial % 2])
        k0 = rng.integers(1, 4, size=4)
        pair = _pair(k0, cfg, routing=routing, names=names)
        for tick in range(3):
            lam0 = float(rng.uniform(2.0, 30.0))
            lam = np.array([lam0, 1.9 * lam0, 0.55 * lam0, 1.6 * lam0]) * rng.uniform(0.9, 1.1, 4)
            mu = rng.uniform(5.0, 40.0, 4)
            d = _tick_both(pair, lam, mu, lam0, t=10.0 * (tick + 1))
            actions.add(d.action)
    assert {"none", "rebalance", "overloaded"} <= actions


def test_decide_single_and_heap_allocators_equal_the_reference():
    ops = [("extract", 30.0), ("match", 90.0), ("aggregate", 400.0)]
    lam0 = np.array([25.0, 0.0, 0.0])
    jtop = JTopology([JSpec(n, m) for n, m in ops], lam0, CHAIN)
    top = Topology([OperatorSpec(n, m) for n, m in ops], lam0, CHAIN)
    for k_max in (3, 5, 9):
        a, b = jalloc.assign_processors(jtop, k_max), talloc.assign_processors(top, k_max)
        np.testing.assert_array_equal(a.k, b.k)
        assert a.expected_sojourn == b.expected_sojourn
    for t_max in (0.2, 0.08):
        a, b = jalloc.min_processors(jtop, t_max), talloc.min_processors(top, t_max)
        np.testing.assert_array_equal(a.k, b.k)
        assert a.expected_sojourn == b.expected_sojourn
    assert set(tctl.ALLOCATORS) == set(jctl.ALLOCATORS)
    kw = dict(t_max=0.1, headroom=1.1, scale_in_hysteresis=0.8, min_improvement=0.05,
              horizon_seconds=300.0, lam_hat=np.array([25.0, 25.0, 25.0]),
              mu_hat=np.array([30.0, 90.0, 400.0]))
    for k_cur in ([1, 1, 1], [2, 1, 1], [1, 2, 2]):
        ra = jctl.decide_single(jtop, np.array(k_cur), 6, **kw)
        rb = tctl.decide_single(top, np.array(k_cur), 6, **kw)
        assert (ra.action, ra.applied, ra.k_max, ra.need_total, ra.reason) == \
            (rb.action, rb.applied, rb.k_max, rb.need_total, rb.reason)
        np.testing.assert_array_equal(ra.k_next, rb.k_next)
        assert _same([ra.et_cur, ra.et_target], [rb.et_cur, rb.et_target])


# --------------------------------------------------------------------------- #
# session, engine and the launch counter
# --------------------------------------------------------------------------- #
def test_live_vld_session_detects_what_the_reference_detects():
    jcfg = JV.VLDConfig()
    jlib = JV.logo_library(jcfg)
    cfg, lib = vld_from_reference(jcfg, jlib)
    rng = np.random.default_rng(4)
    frames = [JV.make_frame(jcfg, rng, lib, rng.random() < 0.5) for _ in range(20)]
    want = []
    for fr in frames:
        desc, valid = JV.extract_features(jnp.asarray(fr), jcfg)
        counts = JV.match_features(desc, valid, jlib, jcfg.match_threshold)
        want.append(np.asarray(JV.aggregate_matches(counts, jcfg.n_logos,
                                                    jcfg.descriptors_per_logo,
                                                    jcfg.detect_threshold)))

    graph, detections = TV.build_vld_graph(cfg, lib, device="cpu")
    # k_max = 3 keeps one worker per operator, so frames stay in order.
    session = DRSSession.bind(graph, "engine", device="cpu",
                              config=SchedulerConfig(k_max=3, min_improvement=0.01))
    assert session.start({"extract": 1, "match": 1, "aggregate": 1}) == \
        {"extract": 1, "match": 1, "aggregate": 1}
    for i, fr in enumerate(frames):
        assert session.inject(fr) is not None
        time.sleep(0.01)
        if i == 9:
            decision = session.tick()
    assert session.drain(timeout=30.0)
    session.stop()
    assert session.history == [decision]
    assert session.allocation == {"extract": 1, "match": 1, "aggregate": 1}
    assert len(session.completed_sojourns) == len(frames)
    assert session.drop_counts() == {"extract": 0, "match": 0, "aggregate": 0}
    assert session.backend.engine.failures == {"extract": 0, "match": 0, "aggregate": 0}
    assert len(detections) == len(frames)
    for got, exp in zip(detections, want):
        np.testing.assert_array_equal(got, exp)
    assert any(d.any() for d in want)


def test_session_refuses_the_unported_backends_and_modes():
    graph = AppGraph.chain([("a", 5.0), ("b", 9.0)], 2.0).with_fns(
        {"a": lambda x: [("b", x)], "b": lambda x: []})
    # The DES is ported; it refuses the live protocol, as the reference's does.
    with pytest.raises(GraphValidationError, match="batch-simulated"):
        DRSSession.bind(graph, "des").start({"a": 1, "b": 1})
    with pytest.raises(GraphValidationError, match="compute fn"):
        AppGraph.chain([("a", 5.0)], 1.0).bind("engine", device="cpu")


def test_engine_counts_a_failing_fn_and_completes_its_root():
    def boom(x):
        raise RuntimeError("kernel failed")

    engine = StreamEngine([Operator("a", lambda x: [("b", x)]), Operator("b", boom)],
                          device="cpu")
    engine.start({"a": 1, "b": 1})
    for i in range(5):
        engine.inject("a", i)
    assert engine.drain(timeout=10.0)
    engine.stop()
    assert engine.failures == {"a": 0, "b": 5}
    assert isinstance(engine.last_failure, RuntimeError)
    assert len(engine.completed_sojourns) == 5


def test_launch_counting_is_exact_across_threads():
    name = "test_threads"
    _build.LAUNCHES.pop(name, None)

    def work():
        for _ in range(20_000):
            _build.count_launch(name)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert _build.LAUNCHES.pop(name) == 8 * 20_000
