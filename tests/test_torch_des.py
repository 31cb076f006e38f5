"""The port's discrete-event simulator against the JAX package's: the same
topology, allocation and seeds give the same event trace, so every field
of ``SimResult`` (``sojourn_series`` included) is equal, on a chain, the
FPD self-loop, a split-join, under each overload policy, each arrival kind
and each service kind, with network delay, a mid-run rebalance and an
attached measurer; ``Scenario.simulator``, ``DRSSession.bind(graph,
"des")`` and ``ServingSimulation`` equal the reference's."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import repro.api.graph as jgraph
import repro.core.measurer as jmeas
import repro.serving.pipeline as jpipe
import repro.serving.router as jrouter
import repro.streaming.des as jdes
from repro.api.session import DRSSession as JaxSession
from repro.streaming import scenarios as jsc
from repro_torch.api import graph as tgraph
from repro_torch.api.session import DESBackend, DRSSession
from repro_torch.convert import scenario_from_reference
from repro_torch.core import measurer as tmeas
from repro_torch.serving import pipeline as tpipe, router as trouter
from repro_torch.streaming import des as tdes, scenarios as tsc

PACKAGES = {"ref": (jgraph, jdes), "port": (tgraph, tdes)}


def _same(x, y) -> bool:
    if isinstance(x, dict):
        return x.keys() == y.keys() and all(_same(x[k], y[k]) for k in x)
    if isinstance(x, (list, tuple)):
        return len(x) == len(y) and all(_same(a, b) for a, b in zip(x, y))
    if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
        return np.array_equal(np.asarray(x), np.asarray(y), equal_nan=True)
    if isinstance(x, float) and np.isnan(x):
        return isinstance(y, float) and np.isnan(y)
    return x == y


def assert_same_result(got, want):
    assert type(got).__name__ == type(want).__name__ == "SimResult"
    for f in dataclasses.fields(want):
        assert _same(getattr(got, f.name), getattr(want, f.name)), f.name
    assert want.completed > 0 and len(want.sojourn_series) == want.completed


def graphs(g, name):
    """The same graph in package ``g``'s classes."""
    Op, E, App = g.OpDef, g.Edge, g.AppGraph
    if name == "chain":
        return App([Op("a", mu=6.0), Op("b", mu=4.0), Op("c", mu=9.0)],
                   [E("a", "b"), E("b", "c")], {"a": 7.0})
    if name == "fpd":
        return App([Op("generate", mu=4.0), Op("detect", mu=3.0), Op("report", mu=12.0)],
                   [E("generate", "detect"), E("detect", "detect", multiplicity=0.3),
                    E("detect", "report", multiplicity=0.7)], {"generate": 10.0})
    if name == "split_join":
        return App([Op("src", mu=9.0), Op("left", mu=3.0), Op("right", mu=5.0),
                    Op("join", mu=12.0, scaling="group", group_alpha=0.05)],
                   [E("src", "left", multiplicity=0.6), E("src", "right", multiplicity=1.5),
                    E("left", "join"), E("right", "join")], {"src": 6.0})
    if name == "service_kinds":
        return App([Op("a", mu=6.0, service_kind="deterministic"),
                    Op("b", mu=4.0, service_kind="uniform"),
                    Op("c", mu=9.0, service_kind="lognormal", service_cv=2.0)],
                   [E("a", "b"), E("b", "c")], {"a": 6.0})
    raise KeyError(name)


K = {"chain": [2, 3, 1], "fpd": [3, 6, 1], "split_join": [2, 2, 3, 2],
     "service_kinds": [2, 3, 1]}


@pytest.mark.parametrize("name", ["chain", "fpd", "split_join"])
def test_simulate_allocation_matches_reference(name):
    out = {}
    for key, (g, d) in PACKAGES.items():
        top = graphs(g, name).topology()
        out[key] = d.simulate_allocation(top, K[name], seed=4, horizon=150.0, warmup=15.0)
    assert_same_result(out["port"], out["ref"])


@pytest.mark.parametrize("policy", ["block", "shed-newest", "shed-oldest"])
def test_overload_policies_match_reference(policy):
    """An overloaded chain (its middle operator at rho 1.4) on bounded
    queues: drops, shed roots and backlogs as the reference's."""
    out = {}
    for key, (g, d) in PACKAGES.items():
        top = graphs(g, "chain").topology()
        out[key] = d.simulate_allocation(top, [2, 1, 1], seed=1, horizon=120.0, warmup=10.0,
                                         queue_capacity=6, overload_policy=policy)
    assert_same_result(out["port"], out["ref"])
    assert (out["ref"].dropped > 0) == (policy != "block")


ARRIVALS = {
    "exponential": {},
    "uniform": {},
    "deterministic": {},
    "mmpp": {"rate2": 14.0, "switch01": 0.2, "switch10": 0.5},
    "burst": {"rate2": 16.0, "burst_every": 30.0, "burst_length": 6.0},
}


@pytest.mark.parametrize("kind", sorted(ARRIVALS))
def test_arrival_kinds_match_reference(kind):
    out = {}
    for key, (g, d) in PACKAGES.items():
        top = graphs(g, "fpd").topology()
        arrivals = [d.ArrivalProcess(rate=float(top.lam0[i]), kind=kind, **ARRIVALS[kind])
                    for i in range(top.n)]
        sim = d.NetworkSimulator(top, K["fpd"], config=d.SimConfig(seed=8, horizon=120.0,
                                                                     warmup=10.0),
                                 arrivals=arrivals)
        out[key] = sim.run()
    assert_same_result(out["port"], out["ref"])


def test_network_delay_rate_changes_and_a_measurer_match_reference():
    """Per-hop delay, a mid-run rebalance with a pause, a service-rate
    and an arrival-rate change, and each package's measurer attached: the
    results and the measurer's snapshot are equal."""
    out, snaps = {}, {}
    for key, (g, d) in PACKAGES.items():
        graph = graphs(g, "split_join")
        top = graph.topology()
        meas = (jmeas if key == "ref" else tmeas).Measurer(graph.names)
        sim = d.NetworkSimulator(top, K["split_join"],
                                 config=d.SimConfig(seed=5, horizon=100.0, warmup=10.0,
                                                    network_delay=0.05),
                                 measurer=meas)
        meas.pull(0.0)
        sim.rebalance_at(40.0, [3, 2, 2, 2], pause=1.5)
        sim.schedule_rate_change(50.0, 1, 4.5, kind="deterministic")
        sim.schedule_arrival_change(60.0, 0, 8.0)
        out[key] = sim.run()
        snaps[key] = meas.pull(sim.now)
    assert_same_result(out["port"], out["ref"])
    for f in ("lam_hat", "mu_hat", "lam0_hat", "sojourn_hat", "t", "drop_hat"):
        assert _same(getattr(snaps["port"], f), getattr(snaps["ref"], f)), f


def test_service_kinds_through_the_des_backend_match_reference():
    want = JaxSession.bind(graphs(jgraph, "service_kinds"), "des", seed=2, horizon=120.0,
                           warmup=10.0).simulate(K["service_kinds"])
    got = DRSSession.bind(graphs(tgraph, "service_kinds"), "des", seed=2, horizon=120.0,
                          warmup=10.0).simulate(K["service_kinds"])
    assert_same_result(got, want)


def test_des_session_rebalances_mid_run_as_the_reference():
    """``bind`` defaults to the DES; ``simulate(rebalance_to=,
    rebalance_at=)`` rescales the group operator's effective server."""
    kw = dict(seed=6, horizon=150.0, warmup=10.0, arrival_kind="mmpp",
              arrival_kw={"rate2": 9.0, "switch01": 0.1, "switch10": 0.3})
    k1 = {"src": 2, "left": 1, "right": 2, "join": 1}
    k2 = {"src": 2, "left": 2, "right": 2, "join": 3}
    jsess = JaxSession.bind(graphs(jgraph, "split_join"), **kw)
    tsess = DRSSession.bind(graphs(tgraph, "split_join"), **kw)
    assert isinstance(tsess.backend, DESBackend) and tsess.backend.kind == "des"
    want = jsess.simulate(k1, rebalance_to=k2, rebalance_at=70.0)
    got = tsess.simulate(k1, rebalance_to=k2, rebalance_at=70.0)
    assert_same_result(got, want)
    assert_same_result(tsess.run(k1), jsess.run(k1))
    assert_same_result(graphs(tgraph, "split_join").bind(**kw).run(k1), jsess.run(k1))


def test_des_session_refuses_the_live_protocol():
    session = DRSSession.bind(graphs(tgraph, "chain"))
    for call in (lambda: session.start({"a": 1, "b": 1, "c": 1}), session.drain,
                 session.stop, lambda: session.inject(1), session.drop_counts):
        with pytest.raises(tgraph.GraphValidationError, match="DES|engine"):
            call()
    engine = DRSSession.bind(graphs(tgraph, "chain").with_fns(
        {"a": lambda x: [], "b": lambda x: [], "c": lambda x: []}), "engine", device="cpu")
    with pytest.raises(tgraph.GraphValidationError, match="DES backend"):
        engine.simulate([1, 1, 1])


@pytest.mark.parametrize("make", ["vld_scenario", "fpd_scenario"])
def test_scenario_simulator_matches_reference(make):
    """The paper's two negotiated scenarios through their event-DES twins
    (trace schedules as mid-run arrival changes), at the planned start."""
    ref = getattr(jsc, make)(horizon=80.0)
    port = getattr(tsc, make)(horizon=80.0)  # the port's own copy of the scenario
    conv = scenario_from_reference(ref)
    assert dataclasses.replace(conv, graph=port.graph) == port
    assert conv.graph.names == port.graph.names
    np.testing.assert_array_equal(conv.graph.routing_matrix(), port.graph.routing_matrix())
    np.testing.assert_array_equal(conv.graph.lam0_vector(), port.graph.lam0_vector())
    k = ref.plan_k0()
    np.testing.assert_array_equal(port.plan_k0(), k)
    assert_same_result(port.simulator(k, seed=3).run(), ref.simulator(k, seed=3).run())
    for tr_ref, tr_port in zip(ref.traces.values(), port.traces.values()):
        assert tr_port.des_schedule(80.0, ref.seed) == tr_ref.des_schedule(80.0, ref.seed)


def test_scenario_simulator_on_a_bounded_matrix_scenario_matches_reference():
    ref = [s for s in jsc.scenario_matrix(10, seed=4, horizon=60.0, warmup=5.0)
           if s.queue_capacity is not None][0]
    port = scenario_from_reference(ref)
    k = ref.plan_k0()
    assert_same_result(port.simulator(k).run(), ref.simulator(k).run())


def test_serving_simulation_matches_reference():
    """The serving pipeline (group-scaled prefill and decode, a decode
    self-loop of 16 tokens on average) under a fixed allocation and a
    mid-run rebalance."""
    def run(pipe, router):
        model = pipe.ServingModel(pipe.StageRates(prefill_per_chip=3.0, decode_per_chip=40.0),
                                  mean_output_tokens=16)
        sim = router.ServingSimulation(model, 2.0, seed=1, horizon=200.0, warmup=20.0)
        plan = sim.drs_allocation(12)
        return (plan, sim.run(plan),
                sim.run({"tokenize": 1, "prefill": 2, "decode": 5, "detokenize": 1},
                        rebalance_to=plan, rebalance_at=100.0))

    want, got = run(jpipe, jrouter), run(tpipe, trouter)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert g.as_dict() == w.as_dict()
        assert g.sojourn_series == w.sojourn_series
        assert g.completed > 0 and np.isfinite(g.mean_latency)
