"""The port's fleet planner and FleetSession against the JAX package's.

Every case of ``tests/test_planner.py`` that needs no mesh runs on the
port, and each plan is held to the reference planner's on the same tenants
(carried across with ``convert.tenant_from_reference``): allocations,
totals, flags, ``unmet`` / ``unreachable`` and ``evaluations`` exactly, the
objective bit for bit (both are the same float64 numpy).  ``plan_batched``
on the CPU: in float64 equal to the scalar plan, in float32 equal to the
JAX ``plan_batched`` without x64."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

import _torch_mesh_ranks as ranks
import repro.core.planner as jplanner
from repro.core import assign_processors_naive
from repro.api import AppGraph as JGraph
from repro.api import FleetSession as JFleetSession
from repro.api import SchedulerConfig as JConfig
from repro.core.jackson import OperatorSpec as JSpec
from repro.core.jackson import Topology as JTopology
from repro.core.measurer import MeasurementSnapshot as JSnapshot
from repro.core.measurer import stack_snapshots as j_stack_snapshots
from repro_torch.api import AppGraph, FleetSession, GraphValidationError, OpDef, SchedulerConfig
from repro_torch.convert import (
    snapshot_from_reference,
    tenant_from_reference,
    topology_from_reference,
)
from repro_torch.core.allocator import InsufficientResourcesError
from repro_torch.core.measurer import stack_snapshots
from repro_torch.core.negotiator import Machine, Negotiator, ResourcePool
from repro_torch.core.planner import FleetPlanner, Tenant
from repro_torch.distributed import FleetMesh, fleet_mesh


def chain_graph(i: int, lam0: float, mus=(2.0, 6.0, 30.0)) -> AppGraph:
    return AppGraph.chain(
        [(f"a{i}", mus[0]), (f"b{i}", mus[1]), (f"c{i}", mus[2])], lam0=lam0
    )


def j_chain_graph(i: int, lam0: float, mus=(2.0, 6.0, 30.0)):
    return JGraph.chain(
        [(f"a{i}", mus[0]), (f"b{i}", mus[1]), (f"c{i}", mus[2])], lam0=lam0
    )


def j_ten_tenants(t_max=1.5):
    return [jplanner.Tenant(name=f"t{i}", graph=j_chain_graph(i, 4.0 + 1.5 * i), t_max=t_max)
            for i in range(10)]


def j_overloaded_tenants():
    return [jplanner.Tenant(f"o{i}", graph=JGraph.chain([(f"u{i}", 2.0)], lam0=10.0),
                            t_max=0.51) for i in range(4)]


def _both(j_tenants, k_max, objective="fair"):
    """The reference planner and the port's on the same tenants."""
    return (jplanner.FleetPlanner(j_tenants, k_max, objective=objective),
            FleetPlanner([tenant_from_reference(t) for t in j_tenants], k_max,
                         objective=objective))


def _same_plan(got, want):
    """The port's plan equal to the reference's: every field exactly, the
    objective bit for bit."""
    assert set(got.k) == set(want.k)
    for name in want.k:
        np.testing.assert_array_equal(got.k[name], want.k[name], err_msg=name)
        assert got.per_tenant[name].expected_sojourn == want.per_tenant[name].expected_sojourn
    for key in ("total", "k_max", "needed_total", "overloaded", "unmet", "unreachable",
                "evaluations"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.objective == want.objective


def _plans_equal(a, b):
    assert set(a.k) == set(b.k)
    for name in a.k:
        np.testing.assert_array_equal(a.k[name], b.k[name], err_msg=name)
    assert a.total == b.total and a.overloaded == b.overloaded
    assert a.unmet == b.unmet and a.unreachable == b.unreachable


# ------------------------------------------------------------------ #
# FleetPlanner: the reference's cases, each plan against the reference's
# ------------------------------------------------------------------ #
def test_fleet_plan_ten_tenants_tmax_honored():
    jp, tp = _both(j_ten_tenants(), 220)
    plan = tp.plan()
    _same_plan(plan, jp.plan())
    assert len(plan.per_tenant) == 10
    assert plan.total <= 220
    assert not plan.overloaded and plan.unmet == ()
    for name, res in plan.per_tenant.items():
        assert res.expected_sojourn <= 1.5, name


def test_fleet_plan_spends_whole_pool_when_beneficial():
    jp, tp = _both(j_ten_tenants(), 220)
    plan = tp.plan()
    _same_plan(plan, jp.plan())
    assert plan.total == 220


def test_fleet_throughput_objective_equals_blockdiag_program4():
    g1 = AppGraph.chain([("x1", 2.0), ("y1", 5.0)], lam0=6.0)
    g2 = AppGraph.chain([("x2", 3.0), ("y2", 8.0)], lam0=9.0)
    plan = FleetPlanner(
        [Tenant("p", graph=g1), Tenant("q", graph=g2)], 30, objective="throughput"
    ).plan()
    ops = [JSpec("x1", 2.0), JSpec("y1", 5.0), JSpec("x2", 3.0), JSpec("y2", 8.0)]
    routing = np.zeros((4, 4))
    routing[0][1] = 1.0
    routing[2][3] = 1.0
    combo = JTopology(ops, np.array([6.0, 0.0, 9.0, 0.0]), routing)
    ref = assign_processors_naive(combo, 30)  # the reference's brute-force oracle
    np.testing.assert_array_equal(np.concatenate([plan.k["p"], plan.k["q"]]), ref.k)
    jp, _ = _both([jplanner.Tenant("p", graph=JGraph.chain([("x1", 2.0), ("y1", 5.0)], 6.0)),
                   jplanner.Tenant("q", graph=JGraph.chain([("x2", 3.0), ("y2", 8.0)], 9.0))],
                  30, objective="throughput")
    _same_plan(plan, jp.plan())


def test_fleet_fair_objective_weights_small_tenants():
    j_tenants = [jplanner.Tenant("small", graph=JGraph.chain([("s1", 2.0), ("s2", 6.0)], 2.0)),
                 jplanner.Tenant("big", graph=JGraph.chain([("b1", 2.0), ("b2", 6.0)], 20.0))]
    plans = {}
    for objective in ("fair", "throughput"):
        jp, tp = _both(j_tenants, 40, objective)
        plans[objective] = tp.plan()
        _same_plan(plans[objective], jp.plan())
    assert plans["fair"].k["small"].sum() >= plans["throughput"].k["small"].sum()


def test_fleet_overloaded_when_floors_exceed_pool():
    jp, tp = _both(j_overloaded_tenants(), 26)
    plan = tp.plan()
    _same_plan(plan, jp.plan())
    assert plan.overloaded
    assert plan.needed_total > 26
    assert plan.total == 26
    assert set(plan.unmet) == {"o0", "o1", "o2", "o3"}


def test_fleet_infeasible_minima_raise():
    with pytest.raises(InsufficientResourcesError):
        FleetPlanner([Tenant("z", graph=AppGraph.chain([("w", 2.0)], lam0=50.0))], 10).plan()
    with pytest.raises(InsufficientResourcesError):
        FleetPlanner([Tenant("z", graph=AppGraph.chain([("w", 2.0)], lam0=50.0))],
                     10).plan_batched(device="cpu")


def test_fleet_unreachable_tmax_listed_not_fatal():
    jp, tp = _both([jplanner.Tenant("ok", graph=j_chain_graph(0, 8.0), t_max=2.0),
                    jplanner.Tenant("impossible", graph=j_chain_graph(1, 8.0), t_max=0.1)], 60)
    plan = tp.plan()
    _same_plan(plan, jp.plan())
    assert plan.unreachable == ("impossible",)
    assert "ok" not in plan.unmet
    assert plan.per_tenant["ok"].expected_sojourn <= 2.0


def test_fleet_measured_topology_override():
    jp, tp = _both([jplanner.Tenant("m", graph=j_chain_graph(0, 5.0), t_max=2.0),
                    jplanner.Tenant("other", graph=j_chain_graph(1, 5.0), t_max=2.0)], 40)
    base = tp.plan()
    j_doubled = j_chain_graph(0, 10.0).topology()
    heavier = tp.plan({"m": topology_from_reference(j_doubled)})
    _same_plan(base, jp.plan())
    _same_plan(heavier, jp.plan({"m": j_doubled}))
    assert heavier.k["m"].sum() > base.k["m"].sum()
    assert heavier.k["other"].sum() < base.k["other"].sum()


def test_tenant_validation():
    with pytest.raises(ValueError):
        Tenant("bad")
    with pytest.raises(ValueError):
        Tenant("bad", graph=chain_graph(0, 1.0), weight=0.0)
    with pytest.raises(ValueError):
        FleetPlanner([Tenant("d", graph=chain_graph(0, 1.0))] * 2, 10)


def test_fleet_idle_tenant_measured_zero_traffic_does_not_crash():
    jp, tp = _both([jplanner.Tenant("busy", graph=j_chain_graph(0, 8.0)),
                    jplanner.Tenant("idle", graph=j_chain_graph(1, 5.0))], 40)
    j_quiet = JTopology([JSpec("a1", 2.0), JSpec("b1", 6.0), JSpec("c1", 30.0)], np.zeros(3),
                        j_chain_graph(1, 5.0).routing_matrix())
    plan = tp.plan({"idle": topology_from_reference(j_quiet)})
    _same_plan(plan, jp.plan({"idle": j_quiet}))
    assert np.isfinite(plan.objective)
    assert plan.k["busy"].sum() + plan.k["idle"].sum() <= 40


# ------------------------------------------------------------------ #
# plan_batched on the CPU: the plain top-R against the scalar greedy
# ------------------------------------------------------------------ #
BATCHED_CASES = {
    "ten-fair": (j_ten_tenants, 220, "fair"),
    "ten-throughput": (j_ten_tenants, 220, "throughput"),
    "overloaded": (j_overloaded_tenants, 26, "fair"),
    "tight": (j_ten_tenants, 205, "fair"),
}


@pytest.mark.parametrize("case", sorted(BATCHED_CASES))
def test_plan_batched_float64_equals_scalar_plan(case):
    """The reference's bitwise contract: in float64 the batched top-R is the
    scalar greedy, plan for plan (and both the reference's scalar plan)."""
    make, k_max, objective = BATCHED_CASES[case]
    jp, tp = _both(make(), k_max, objective)
    scalar = tp.plan()
    batched = tp.plan_batched(device="cpu", dtype=torch.float64)
    _plans_equal(scalar, batched)
    _same_plan(batched, jp.plan())


@pytest.mark.parametrize("case", sorted(BATCHED_CASES))
def test_plan_batched_float32_equals_jax_plan_batched(case):
    """Without x64 the JAX planner selects in float32; so does the port's
    default dtype, on the same candidates."""
    make, k_max, objective = BATCHED_CASES[case]
    jp, tp = _both(make(), k_max, objective)
    _same_plan(tp.plan_batched(device="cpu"), jp.plan_batched())


def test_plan_batched_refuses_a_mesh():
    """What ``mesh=`` still refuses: a mesh that is not a 1-D fleet mesh
    (the reference's message for a 2-D one)."""
    _, tp = _both(j_ten_tenants(), 220)
    two_d = FleetMesh(group=None, size=1, rank=0, device=torch.device("cpu"),
                      axis_names=("a", "b"))
    with pytest.raises(ValueError, match="fleet mesh must be 1-D"):
        tp.plan_batched(device="cpu", mesh=two_d)
    with pytest.raises(ValueError, match="FleetMesh"):
        tp.plan_batched(device="cpu", mesh=object())


@pytest.fixture(scope="module")
def mesh_plans(tmp_path_factory):
    """The reference planner's cases and a batched FleetSession on gloo
    meshes of 2 and 4 ranks (the CPU)."""
    return {d: ranks.run_ranks(d, ("plans", "fleet-session"), tmp_path_factory.mktemp(f"p{d}"))
            for d in (2, 4)}


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("case", sorted(ranks.PLAN_CASES))
def test_plan_batched_on_a_mesh_equals_the_unsharded_plans(mesh_plans, case, d):
    """The fleet reduction over 2 and 4 ranks (4 pads the rows): every rank's
    float64 plan is the scalar greedy's and the reference's ``plan()``, its
    float32 plan the unsharded float32 plan, take for take."""
    make, k_max, objective = ranks.PLAN_CASES[case]
    j_make = {"ten-fair": j_ten_tenants, "ten-throughput": j_ten_tenants,
              "overloaded": j_overloaded_tenants, "tight": j_ten_tenants}[case]
    jp, tp = _both(j_make(), k_max, objective)
    want = {"float64": jp.plan(), "float32": tp.plan_batched(device="cpu")}
    _plans_equal(tp.plan(), want["float64"])
    for rank, res in mesh_plans[d].items():
        got = res["plans"]
        for dt, plan in want.items():
            tag = f"{case}/{dt}"
            for name, k in plan.k.items():
                np.testing.assert_array_equal(got[f"{tag}/{name}"], k, err_msg=f"{rank} {tag}")
            assert int(got[f"{tag}/total"]) == plan.total
            assert bool(got[f"{tag}/overloaded"]) == plan.overloaded


@pytest.mark.parametrize("d", [2, 4])
def test_fleet_session_on_a_mesh_equals_the_unsharded_session(mesh_plans, d):
    want = ranks.fleet_session_plans()
    for rank, res in mesh_plans[d].items():
        got = res["fleet-session"]
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{rank} {key}")


def _fleet_256():
    """The chip check's fleet at full size: 256 ``scenario_matrix`` tenants
    (each its scenario's mean topology and t_max), 1,298 operator rows."""
    from repro.streaming.scenarios import scenario_matrix

    scens = scenario_matrix(256, seed=5, horizon=30.0, warmup=5.0, dt=0.05, k_max=48)
    return [jplanner.Tenant(s.name, topology=s.mean_topology(), t_max=s.t_max)
            for s in scens]


def test_fleet_of_256_tenants_floors_and_batched_plan():
    """1,298 rows whose Program-(6) floors sum to 3,011: at a pool of 5,059
    the batched plan (float32 and float64) equals the reference's scalar
    plan; below the floors the plan is overloaded in both packages."""
    j_tenants = _fleet_256()
    jp, tp = _both(j_tenants, 5059)
    want = jp.plan()
    assert sum(t.resolve().n for t in j_tenants) == 1298
    assert want.needed_total == 3011
    _same_plan(tp.plan(), want)
    _plans_equal(tp.plan_batched(device="cpu", dtype=torch.float64), want)
    _plans_equal(tp.plan_batched(device="cpu"), want)
    jp_low, tp_low = _both(j_tenants, 3000)
    low = tp_low.plan_batched(device="cpu")
    assert low.overloaded and low.total == 3000
    _same_plan(low, jp_low.plan_batched())


def test_stack_snapshots_equals_the_reference():
    rng = np.random.default_rng(3)
    j_snaps = []
    for n in (3, 1, 5):
        drop = None if n == 1 else rng.uniform(0, 0.5, n)
        j_snaps.append(JSnapshot(rng.uniform(1, 9, n), rng.uniform(2, 7, n),
                                 float(rng.uniform(1, 5)), float(rng.uniform(0.1, 2)), 12.5,
                                 drop_hat=drop))
    for width in (None, 7):
        want = j_stack_snapshots(j_snaps, width)
        got = stack_snapshots([snapshot_from_reference(s) for s in j_snaps], width)
        for key in ("lam_hat", "mu_hat", "lam0_hat", "sojourn_hat", "drop_hat"):
            np.testing.assert_array_equal(getattr(got, key), getattr(want, key), err_msg=key)
        assert got.t == want.t
    with pytest.raises(ValueError):
        stack_snapshots([])


# ------------------------------------------------------------------ #
# FleetSession (model-only and negotiator-driven)
# ------------------------------------------------------------------ #
def chain_graph_2(i, lam0, mus=(2.0, 6.0)):
    return AppGraph.chain([(f"a{i}", mus[0]), (f"b{i}", mus[1])], lam0=lam0)


def make_sessions(n=8, t_max=1.2):
    return {f"t{i}": chain_graph_2(i, 4.0 + i).bind("des", config=SchedulerConfig(t_max=t_max))
            for i in range(n)}


def j_make_sessions(n=8, t_max=1.2):
    return {f"t{i}": JGraph.chain([(f"a{i}", 2.0), (f"b{i}", 6.0)], lam0=4.0 + i).bind(
        "des", config=JConfig(t_max=t_max)) for i in range(n)}


def _same_decision(got, want):
    assert got.action == want.action
    assert got.k_max == want.k_max
    assert got.k == want.k
    assert got.overloaded_tenants == want.overloaded_tenants
    assert got.objective_current == want.objective_current
    assert (got.plan is None) == (want.plan is None)
    if want.plan is not None:
        _same_plan(got.plan, want.plan)


def _feed(sched, rng_seed, scale=1):
    """Hand-feed one measurement window into a scheduler's measurer (the
    same probe events in both packages), its arrivals ``scale`` times."""
    rng = np.random.default_rng(rng_seed)
    m = sched.measurer
    for name in sched.names:
        probe = m.new_probe(name)
        probe.on_enqueue(int(rng.integers(200, 400)) * scale)
        for _ in range(20):
            for _ in range(m.n_m - 1):
                probe.on_processed(0.0)
            probe.on_processed(float(rng.uniform(0.1, 0.4)))
    m.on_external_arrival(int(rng.integers(200, 300)) * scale)
    m.on_tuple_complete(float(rng.uniform(0.5, 2.0)), 100)


@pytest.mark.parametrize("solver", ["scalar", "batched"])
def test_fleet_session_decisions_equal_the_reference(solver):
    """Model-only tenants fed the same measurements: the fleet ticks'
    actions, allocations and current objectives equal the reference's
    (the batched solver in float64 against the reference's scalar).  The
    load moves from tenant 0 to tenant 1 (a rebalance), then tenant 2 runs
    hot."""
    scales = [(1, 1, 1, 1), (6, 1, 1, 1), (1, 6, 1, 1), (1, 6, 30, 1)]
    fleets = [JFleetSession(j_make_sessions(4), k_max=60),
              FleetSession(make_sessions(4), k_max=60, solver=solver, device="cpu",
                           dtype=torch.float64)]
    for fleet in fleets:
        fleet.start()
        for tick, scale in enumerate(scales):
            for bi, s in enumerate(fleet.sessions.values()):
                s.scheduler.measurer.pull(60.0 * tick)
                _feed(s.scheduler, 100 * tick + bi, scale[bi])
            fleet.tick(now=60.0 * (tick + 1))
    want, got = fleets[0].history, fleets[1].history
    assert [d.action for d in got] == [d.action for d in want]
    assert {"rebalance", "overloaded"} <= {d.action for d in got}
    for g, w in zip(got, want):
        _same_decision(g, w)


def test_fleet_session_start_and_tick_model_only():
    fleet = FleetSession(make_sessions(), k_max=90)
    ks = fleet.start()
    assert set(ks) == {f"t{i}" for i in range(8)}
    assert sum(sum(v.values()) for v in ks.values()) <= 90
    d = fleet.tick(now=0.0)
    assert d.action in ("none", "rebalance")
    plan = fleet.plan()
    for name, res in plan.per_tenant.items():
        assert res.expected_sojourn <= 1.2, name
    j_fleet = JFleetSession(j_make_sessions(), k_max=90)
    assert j_fleet.start() == ks
    _same_decision(d, j_fleet.tick(now=0.0))


def test_fleet_session_negotiator_acquires_lease():
    pool = ResourcePool([Machine(f"m{i}", 4) for i in range(40)])
    fleet = FleetSession(make_sessions(), negotiator=Negotiator(pool))
    fleet.start()
    assert fleet.k_max > 0
    d = fleet.tick(now=0.0)
    assert d.action in ("none", "rebalance")
    total = sum(sum(v.values()) for v in fleet.allocations().values())
    assert total <= fleet.k_max


def test_fleet_session_requires_budget_and_known_solver():
    with pytest.raises(GraphValidationError):
        FleetSession(make_sessions(2))
    with pytest.raises(GraphValidationError):
        FleetSession(make_sessions(2), k_max=20, solver="heap")
    with pytest.raises(GraphValidationError, match="mesh= requires solver='batched'"):
        FleetSession(make_sessions(2), k_max=20, device="cpu",
                     mesh=fleet_mesh(1, device="cpu"))


def test_fleet_session_engine_tenants_live():
    """Two live engine tenants on the CPU on one pool: start under the
    planned split, drive traffic, tick the fleet with the batched solver,
    shut down cleanly.  No timing is asserted (wall-clock windows)."""

    def fast(_x):
        time.sleep(0.001)
        return []

    sessions = {}
    for i in range(2):
        g = AppGraph([OpDef(f"w{i}", mu=400.0, fn=fast)], [], {f"w{i}": 30.0})
        sessions[f"live{i}"] = g.bind("engine", config=SchedulerConfig(t_max=1.0),
                                      queue_capacity=1000, device="cpu")
    fleet = FleetSession(sessions, k_max=8, solver="batched", device="cpu")
    try:
        ks = fleet.start()
        assert all(sum(v.values()) >= 1 for v in ks.values())
        t0 = time.perf_counter()
        sent = 0
        while time.perf_counter() - t0 < 0.8:
            for name in sessions:
                sessions[name].inject(sent)
            sent += 1
            time.sleep(0.01)
        d = fleet.tick()
        assert d.action in ("none", "rebalance", "overloaded")
        total = sum(sum(v.values()) for v in fleet.allocations().values())
        assert total <= fleet.k_max
    finally:
        fleet.stop()


def test_fleet_session_overload_fast_path():
    g = AppGraph.chain([("hot", 2.0)], lam0=4.0)
    session = g.bind("des", config=SchedulerConfig(t_max=2.0))
    pool = ResourcePool([Machine(f"m{i}", 2) for i in range(20)])
    fleet = FleetSession({"hot": session}, negotiator=Negotiator(pool))
    fleet.start()
    k_before = fleet.k_max
    m = session.scheduler.measurer
    probe = m.new_probe("hot")
    m.pull(0.0)
    probe.on_enqueue(600)
    for _ in range(30):
        for _ in range(m.n_m - 1):
            probe.on_processed(0.0)
        probe.on_processed(0.5)
    m.on_external_arrival(120)
    m.on_tuple_complete(3.0, 120)
    d = fleet.tick(now=60.0)
    assert d.action == "overloaded"
    assert "hot" in d.overloaded_tenants
    assert fleet.k_max >= k_before
    assert sum(fleet.allocations()["hot"].values()) >= 6


def test_fleet_session_no_scale_in_without_tmax():
    pool = ResourcePool([Machine(f"m{i}", 4) for i in range(30)])
    neg = Negotiator(pool)
    neg.ensure(100)
    sessions = {f"t{i}": chain_graph_2(i, 4.0 + i).bind("des", config=SchedulerConfig())
                for i in range(3)}
    fleet = FleetSession(sessions, negotiator=neg)
    fleet.start()
    k_leased = fleet.k_max
    d = fleet.tick(now=0.0)
    assert d.action != "scale_in"
    assert fleet.k_max == k_leased
    assert sum(sum(v.values()) for v in fleet.allocations().values()) <= fleet.k_max


def test_fleet_session_scale_in_applies_shrunk_allocation():
    pool = ResourcePool([Machine(f"m{i}", 4) for i in range(40)])
    neg = Negotiator(pool)
    neg.ensure(140)
    sessions = {f"t{i}": chain_graph_2(i, 4.0 + i).bind("des", config=SchedulerConfig(t_max=1.2))
                for i in range(3)}
    fleet = FleetSession(sessions, negotiator=neg)
    fleet.start()
    assert fleet.k_max == 140
    d = fleet.tick(now=0.0)
    assert d.action == "scale_in"
    assert fleet.k_max < 140
    assert sum(sum(v.values()) for v in fleet.allocations().values()) <= fleet.k_max
    for name in sessions:
        assert d.plan.per_tenant[name].expected_sojourn <= 1.2


# ------------------------------------------------------------------ #
# On the card
# ------------------------------------------------------------------ #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("tenants", [256, 1024])
def test_cuda_plan_batched_equals_the_plain_float32_plan(cuda_device, tenants):
    """The 256-tenant fleet's [1, 1298, 2048] tile and the 1,024-tenant
    fleet's [1, 5128, 2048] (past the 4,093 rows the old block route held)
    on the grid route: the kernel's plan equals the plain version's, and
    one launch per plan."""
    from repro.streaming.scenarios import scenario_matrix

    from repro_torch.kernels import LAUNCHES

    if tenants == 256:
        tp = FleetPlanner([tenant_from_reference(t) for t in _fleet_256()], 5059)
    else:
        scens = scenario_matrix(1024, seed=5, horizon=30.0, warmup=5.0, dt=0.05, k_max=48)
        tp = FleetPlanner([tenant_from_reference(jplanner.Tenant(
            s.name, topology=s.mean_topology(), t_max=s.t_max)) for s in scens], 11690 + 2048)
    before = LAUNCHES["gain_topr"]
    got = tp.plan_batched(device=cuda_device)
    assert LAUNCHES["gain_topr"] == before + 1
    _same_plan(got, tp.plan_batched(device="cpu"))
