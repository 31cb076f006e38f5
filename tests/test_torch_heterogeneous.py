"""The port's heterogeneous-processor allocation against the JAX
package's: every case of ``tests/test_heterogeneous.py``, and
``assign_heterogeneous`` equal to the reference's (speeds, k, E[T] bit for
bit) on seeded topologies and pools."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from repro.core import heterogeneous as jhet
from repro.streaming.scenarios import random_appgraph
from repro_torch.convert import speed_pool_from_reference, topology_from_reference
from repro_torch.core.allocator import InsufficientResourcesError, assign_processors
from repro_torch.core.heterogeneous import SpeedPool, assign_heterogeneous
from repro_torch.core.jackson import OperatorSpec, Topology


def vld():
    """The reference's VLD chain, carried across."""
    return topology_from_reference(
        jhet.Topology.chain([("extract", 2.0), ("match", 5.0), ("agg", 50.0)], lam0=13.0))


def test_homogeneous_pool_matches_algorithm1():
    top = vld()
    het = assign_heterogeneous(top, SpeedPool.of({1.0: 22}))
    hom = assign_processors(top, 22)
    np.testing.assert_array_equal(het.k, hom.k)
    assert het.expected_sojourn == pytest.approx(hom.expected_sojourn, rel=1e-9)


def test_fast_processors_go_to_bottleneck():
    het = assign_heterogeneous(vld(), SpeedPool.of({2.0: 4, 1.0: 18}))
    assert math.isfinite(het.expected_sojourn)
    assert all(s == 1.0 for s in het.speeds[2])
    assert sum(s == 2.0 for ops in het.speeds for s in ops) == 4
    assert sum(s == 2.0 for s in het.speeds[0]) >= 2


def test_faster_pool_beats_slower_pool():
    slow = assign_heterogeneous(vld(), SpeedPool.of({1.0: 22}))
    fast = assign_heterogeneous(vld(), SpeedPool.of({2.0: 8, 1.0: 14}))
    assert fast.expected_sojourn < slow.expected_sojourn


def test_insufficient_heterogeneous_pool_raises():
    with pytest.raises(InsufficientResourcesError):
        assign_heterogeneous(vld(), SpeedPool.of({0.5: 10}))


def test_mixed_pool_stabilises_all_operators():
    top = vld()
    het = assign_heterogeneous(top, SpeedPool.of({1.5: 6, 1.0: 10, 0.5: 10}))
    mu_eff = het.effective_mu([op.mu for op in top.operators])
    lam = top.arrival_rates
    for i in range(top.n):
        assert het.k[i] * mu_eff[i] > lam[i]


def test_uniform_speed_pool_matches_speed_factor_scheduler():
    """A uniform-speed pool is the exact case of the mean-speed model:
    assign_heterogeneous at speed s == Algorithm 1 on mu * s ==
    DRSScheduler(speed_factors=s) Program 4."""
    from repro_torch.core.measurer import MeasurementSnapshot
    from repro_torch.core.scheduler import DRSScheduler, SchedulerConfig

    top = vld()
    s, k_total = 0.5, 30
    het = assign_heterogeneous(top, SpeedPool.of({s: k_total}))
    scaled = Topology([OperatorSpec(op.name, op.mu * s) for op in top.operators],
                      top.lam0, top.routing)
    hom = assign_processors(scaled, k_total)
    np.testing.assert_array_equal(het.k, hom.k)
    assert het.expected_sojourn == pytest.approx(hom.expected_sojourn, rel=1e-9)
    sched = DRSScheduler([op.name for op in top.operators], top.routing, het.k.copy(),
                         SchedulerConfig(k_max=k_total), speed_factors=[s] * top.n)
    snap = MeasurementSnapshot.from_rates(top.arrival_rates, [op.mu for op in top.operators],
                                          top.lam0_total, 1.0, 60.0)
    d = sched.tick_from(snap, 60.0)
    assert d.action in ("none", "rebalance")
    np.testing.assert_array_equal(d.k_target, het.k)
    assert d.model_sojourn_target == pytest.approx(het.expected_sojourn, rel=1e-9)


def test_scenario_speed_factors_match_prescaled_mus():
    """A Scenario with speed_factors decides bit-identically to the same
    scenario with the factors baked into the declared mus."""
    from repro_torch.api import AppGraph, Edge, OpDef, ScenarioRunner
    from repro_torch.streaming.scenarios import ArrivalTrace, Scenario

    def graph(scale):
        return AppGraph([OpDef("a", mu=2.0 * scale[0]), OpDef("b", mu=5.0 * scale[1]),
                         OpDef("c", mu=50.0 * scale[2])],
                        [Edge("a", "b"), Edge("b", "c")], {"a": 10.0})

    factors = (0.5, 1.5, 1.0)
    base = dict(traces={"a": ArrivalTrace(kind="flash", rate=8.0, peak=16.0, t_on=10.0,
                                          t_off=20.0)},
                seed=3, horizon=30.0, warmup=5.0, dt=0.05, k_max=32, t_max=None)
    hetero = Scenario(name="hetero", graph=graph((1.0, 1.0, 1.0)),
                      speed_factors={"a": factors[0], "b": factors[1], "c": factors[2]}, **base)
    baked = Scenario(name="baked", graph=graph(factors), **base)
    r_het = ScenarioRunner([hetero], tick_interval=5.0, backend="numpy")
    r_bak = ScenarioRunner([baked], tick_interval=5.0, backend="numpy")
    rep_het, rep_bak = r_het.run()[0], r_bak.run()[0]
    assert list(rep_het.actions) == list(rep_bak.actions)
    assert rep_het.k_final == rep_bak.k_final
    np.testing.assert_array_equal(r_het.k, r_bak.k)


def test_negotiated_scenario_lease_carries_machine_speed():
    from repro_torch.api import ScenarioRunner
    from repro_torch.streaming.scenarios import vld_scenario

    s = vld_scenario(speed_factors={"extract": 0.5, "match": 0.5, "aggregate": 0.5})
    neg = ScenarioRunner([s], tick_interval=10.0, backend="numpy").negotiators[0]
    assert neg is not None
    machines = neg.pool.leased + neg.pool.available
    assert machines and all(m.speed == 0.5 for m in machines)


def _pools(rng):
    speeds = (2.0, 1.5, 1.0, 0.75, 0.5)
    for _ in range(3):
        chosen = rng.choice(len(speeds), size=int(rng.integers(1, 4)), replace=False)
        yield jhet.SpeedPool.of({speeds[i]: int(rng.integers(4, 24)) for i in chosen})


@pytest.mark.parametrize("seed", range(6))
def test_assign_heterogeneous_equals_the_reference(seed):
    """Seeded random graphs and pools: the same speeds per operator, the
    same k and the same E[T] bit for bit (or the same error)."""
    rng = np.random.default_rng(seed)
    jtop = random_appgraph(seed, n_ops=(2, 6)).topology()
    top = topology_from_reference(jtop)
    for jpool in _pools(rng):
        pool = speed_pool_from_reference(jpool)
        assert pool.draws() == jpool.draws()
        try:
            want = jhet.assign_heterogeneous(jtop, jpool)
        except jhet.InsufficientResourcesError:
            with pytest.raises(InsufficientResourcesError):
                assign_heterogeneous(top, pool)
            continue
        got = assign_heterogeneous(top, pool)
        assert got.speeds == want.speeds
        np.testing.assert_array_equal(got.k, want.k)
        assert got.expected_sojourn == want.expected_sojourn or (
            math.isinf(got.expected_sojourn) and math.isinf(want.expected_sojourn))
        assert got.effective_mu([op.mu for op in top.operators]) == \
            want.effective_mu([op.mu for op in jtop.operators])


def test_the_module_stays_on_the_host():
    """Numpy float64 throughout: no tensor in, none out."""
    het = assign_heterogeneous(vld(), SpeedPool.of({1.5: 6, 1.0: 16}))
    assert isinstance(het.k, np.ndarray) and het.k.dtype == np.int64
    assert not any(isinstance(x, torch.Tensor) for ops in het.speeds for x in ops)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def test_cuda_prices_a_uniform_speed_pool_as_the_host(cuda_device):
    """A uniform-speed pool's allocation priced on the card (one
    ``erlang_c`` table, float32) agrees with its float64 E[T] to 1e-5, the
    bound ``expected_sojourn_batch`` is held to on the card."""
    from repro_torch.core.batched import expected_sojourn_batch

    top = vld()
    for s in (0.5, 1.0, 2.0):
        het = assign_heterogeneous(top, SpeedPool.of({s: 30}))
        scaled = Topology([OperatorSpec(op.name, op.mu * s) for op in top.operators],
                          top.lam0, top.routing)
        got = expected_sojourn_batch(scaled, het.k[None], device=cuda_device)[0]
        assert got == pytest.approx(het.expected_sojourn, rel=1e-5)
