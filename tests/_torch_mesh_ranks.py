"""Ranks of a gloo fleet mesh on the CPU, for the port's mesh tests.

:func:`run_ranks` spawns ``world`` processes (``torch.multiprocessing``,
the spawn method), joins them into one gloo process group through a
``file://`` store in the test's own directory (no TCP port, so parallel
test workers never collide), and runs the named :data:`CASES` on every rank
against ``fleet_mesh(world)``.  Each rank saves each case's result (a dict
of numpy arrays) as ``r<rank>-<case>.npz``; :func:`run_ranks` returns them
as ``{rank: {case: dict}}``.  A rank that raises fails the whole run, and a
run past its deadline is killed and fails.

This module imports neither JAX nor the JAX package: the spawned ranks
import it, and the port alone.
"""

from __future__ import annotations

import pathlib
import time

import numpy as np
import torch

from repro_torch.api.session import FleetSession, ScenarioRunner
from repro_torch.checkpoint import CheckpointStore
from repro_torch.core import controller as ctl
from repro_torch.distributed import fleet_mesh
from repro_torch.forecast.mpc import MPCConfig
from repro_torch.forecast.predictors import PredictorParams
from repro_torch.streaming.scenarios import scenario_matrix

#: Decisions, allocations and integer aggregates: compared bitwise.
EXACT = (
    "codes", "k", "applied", "miss", "warm_windows", "k_final", "q_final",
    "offered", "served", "dropped", "ext_admitted", "ext_offered",
    "q_int", "q_max", "mpc_used", "confident", "repriced", "eligible",
)
#: The E[T] diagnostics: rtol 1e-6 port against port.
CLOSE = ("sojourn", "et_cur", "et_target")
#: The fused loop's modes under test (ScenarioRunner keywords).
LOOP_MODES = {
    "dense": {},
    "fused": {"fused_decide": True},
    "compact": {"compact": True},
    "proactive": {"proactive": "mpc"},
}


def scens(b: int, seed: int = 11):
    """``b`` static-budget ``scenario_matrix`` scenarios, 4 ticks of 5 s."""
    return [s.with_(negotiated=False)
            for s in scenario_matrix(b, seed=seed, horizon=20.0, warmup=5.0, dt=0.05)]


def mpc_cfg() -> MPCConfig:
    return MPCConfig(horizon=3, window=12, min_scored=2,
                     predictor=PredictorParams(kind="holt", alpha=0.6, beta=0.4))


def runner(scenarios, mode: str, mesh=None) -> ScenarioRunner:
    kw = dict(LOOP_MODES[mode])
    if kw.get("proactive") == "mpc":
        kw["proactive"] = mpc_cfg()
    return ScenarioRunner(scenarios, tick_interval=5.0, mesh=mesh, device="cpu", **kw)


def loop_of(r: ScenarioRunner, mesh=None):
    return ctl.make_fused_loop(
        r.arrays, r.static, r.params, steps_per_tick=r._steps_per_tick,
        warmup_seconds=r.scenarios[0].warmup, proactive=r.proactive_cfg, compact=r.compact,
        mesh=mesh, device="cpu")


def np_out(out: dict) -> dict:
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in out.items()}


def loop_run(b: int, mode: str, mesh=None, seed: int = 11) -> dict:
    """The fused loop's whole run over ``scens(b, seed)``."""
    r = runner(scens(b, seed), mode, mesh)
    loop, _ = loop_of(r, mesh)
    return np_out(loop(r.k))


def chunked_run(b: int, mesh=None) -> dict:
    """One tick, then the rest, stitched as the soak stitches chunks."""
    r = runner(scens(b), "dense", mesh)
    loop, _ = loop_of(r, mesh)
    state, first = loop.run(loop.init(r.k), 1)
    _state, rest = loop.run(state)
    first, rest = np_out(loop.gather(first)), np_out(loop.gather(rest))
    for key in ("codes", "k", "sojourn", "et_cur", "et_target", "applied"):
        rest[key] = np.concatenate([first[key], rest[key]])
    rest["miss"] = rest["miss"] + first["miss"]
    rest["warm_windows"] = rest["warm_windows"] + first["warm_windows"]
    return rest


def decide_inputs(b: int, n: int, active):
    rng = np.random.default_rng(2)
    lam = np.abs(rng.normal(2.0, 0.6, (b, n)))
    mu = np.abs(rng.normal(6.0, 0.5, (b, n))) + 1.0
    lam0 = np.abs(rng.normal(2.0, 0.5, b))
    return lam, mu, np.zeros((b, n)), lam0, np.where(active, 2, 0).astype(np.int64)


def decide_run(b: int, compact: bool, mesh=None) -> dict:
    """The standalone decide on one set of measurements (dense), or over
    four calls (cold, quiet, one lane perturbed, quiet) with the repriced
    counts (compacted)."""
    r = runner(scens(b, 13), "dense")
    lam, mu, drop, lam0, k = decide_inputs(b, r.static.n, r.static.active)
    decide = ctl.make_decide(r.static, r.params, compact=compact or None, mesh=mesh,
                             device="cpu")
    names = ("code", "k_next", "et_cur", "et_target", "applied")
    if not compact:
        return dict(zip(names, (o.numpy() for o in decide(lam, mu, drop, lam0, k))))
    cache = decide.init_cache()
    lam2 = lam.copy()
    lam2[3] *= 1.5
    res = {}
    for call, lam_t in enumerate((lam, lam, lam2, lam2)):
        outs, repriced, cache = decide(lam_t, mu, drop, lam0, k, cache)
        res.update({f"{name}{call}": o.numpy() for name, o in zip(names, outs)})
        res[f"repriced{call}"] = repriced.numpy()
    return res


def runner_reports(b: int, mesh=None) -> dict:
    """``ScenarioRunner.run()``'s reports: per scenario its actions, final
    allocation and trajectories."""
    res = {}
    for i, rep in enumerate(runner(scens(b, 23), "dense", mesh).run()):
        res[f"{i}/codes"] = np.array([ctl.ACTIONS.index(a) for a in rep.actions])
        res[f"{i}/k_final"] = np.array(list(rep.k_final.values()))
        for key in ("k_total", "miss", "sojourn"):
            res[f"{i}/{key}"] = np.array(rep.trajectory[key])
    return res


def chain_tenants():
    """The reference planner's ten-tenant fleet (tests/test_planner.py)."""
    from repro_torch.api import AppGraph
    from repro_torch.core.planner import Tenant

    return [Tenant(name=f"t{i}", graph=AppGraph.chain(
        [(f"a{i}", 2.0), (f"b{i}", 6.0), (f"c{i}", 30.0)], lam0=4.0 + 1.5 * i), t_max=1.5)
        for i in range(10)]


def overloaded_tenants():
    from repro_torch.api import AppGraph
    from repro_torch.core.planner import Tenant

    return [Tenant(f"o{i}", graph=AppGraph.chain([(f"u{i}", 2.0)], lam0=10.0), t_max=0.51)
            for i in range(4)]


#: The reference planner's cases: (tenants, pool, objective).
PLAN_CASES = {
    "ten-fair": (chain_tenants, 220, "fair"),
    "ten-throughput": (chain_tenants, 220, "throughput"),
    "overloaded": (overloaded_tenants, 26, "fair"),
    "tight": (chain_tenants, 205, "fair"),
}


def plan_takes(mesh=None) -> dict:
    """``plan_batched`` of every :data:`PLAN_CASES` case in float64 and
    float32: each tenant's allocation, total and overload flag."""
    from repro_torch.core.planner import FleetPlanner

    res = {}
    for case, (make, pool, objective) in PLAN_CASES.items():
        planner = FleetPlanner(make(), pool, objective=objective)
        for dt in (torch.float64, torch.float32):
            plan = planner.plan_batched(mesh=mesh, device="cpu", dtype=dt)
            tag = f"{case}/{str(dt)[6:]}"
            for name, k in plan.k.items():
                res[f"{tag}/{name}"] = k
            res[f"{tag}/total"] = np.array(plan.total)
            res[f"{tag}/overloaded"] = np.array(plan.overloaded)
    return res


def fleet_session_plans(mesh=None) -> dict:
    """A batched FleetSession over eight model-only chain tenants (the
    planner tests' fleet): its start split and one tick's allocations."""
    from repro_torch.api import AppGraph, SchedulerConfig

    sessions = {f"t{i}": AppGraph.chain([(f"a{i}", 2.0), (f"b{i}", 6.0)], lam0=4.0 + i).bind(
        "des", config=SchedulerConfig(t_max=1.2)) for i in range(8)}
    fleet = FleetSession(sessions, k_max=90, solver="batched", mesh=mesh, device="cpu")
    res = {f"start/{t}/{op}": np.array(k) for t, a in fleet.start().items()
           for op, k in a.items()}
    d = fleet.tick(now=0.0)
    res.update({f"tick/{t}/{op}": np.array(k) for t, a in d.k.items() for op, k in a.items()})
    res["action"] = np.array(d.action)
    return res


def soak_runs(directory: pathlib.Path, mesh=None) -> dict:
    """The two-hour soak, straight and checkpointed (three restores)."""
    from repro_torch.streaming.soak import SoakConfig, run_checkpointed, run_straight

    cfg = SoakConfig.smoke()
    straight = run_straight(cfg, mesh=mesh, device="cpu")
    chk = run_checkpointed(cfg, directory / "soak", mesh=mesh, device="cpu")
    res = {f"straight/{k}": v for k, v in straight.items()}
    res.update({f"stitched/{k}": np.asarray(v) for k, v in chk.items()})
    return res


def checkpoint_layouts(directory: pathlib.Path, mesh) -> dict:
    """Across layouts (B = 4 on two ranks, no padding): save the sharded
    carry after one tick to ``sharded/``; restore ``plain/`` (an unsharded
    carry, saved after one tick before the ranks started) onto the sharded
    loop's template and run the rest."""
    r = runner(scens(4, 19), "dense", mesh)
    loop, _ = loop_of(r, mesh)
    state, _ = loop.run(loop.init(r.k), 1)
    store = CheckpointStore(directory / "sharded", mesh=mesh)
    store.save(1, state)
    restored, _ = CheckpointStore(directory / "plain", mesh=mesh).restore(loop.init(r.k),
                                                                          step=1)
    _, out = loop.run(ctl.ControllerState(*restored))
    return np_out(loop.gather(out))


def carry_shards(b: int, mode: str, mesh) -> dict:
    """What a rank holds between runs: the lanes of its carry and of each
    per-tick output after one tick and after the rest, and the
    ``all_gather`` calls each ``run`` and the ``gather`` made (counted
    through a wrapped ``FleetMesh.all_gather``).  The gathered outputs of
    the chunked run are returned too."""
    from repro_torch.distributed import FleetMesh

    calls = [0]
    plain = FleetMesh.all_gather

    def counted(self, x, dim=0):
        calls[0] += 1
        return plain(self, x, dim)

    r = runner(scens(b), mode, mesh)
    loop, _ = loop_of(r, mesh)
    FleetMesh.all_gather = counted
    try:
        state = loop.init(r.k)
        res = {"init_gathers": np.array(calls[0])}
        state, first = loop.run(state, 1)
        res["run1_gathers"] = np.array(calls[0] - res["init_gathers"])
        state, rest = loop.run(state)
        res["run2_gathers"] = np.array(calls[0] - res["init_gathers"] - res["run1_gathers"])
        res["carry_lanes"] = np.array([t.shape[0] for t in (state.q, state.served_prev,
                                                             state.k, *state.acc,
                                                             *state.fstate)])
        res["out_lanes"] = np.array([v.shape[1] for key, v in rest.items()
                                     if isinstance(v, torch.Tensor) and v.ndim >= 2
                                     and key not in ("k_final", "q_final", "offered",
                                                     "served", "dropped", "q_int", "q_max")])
        before = calls[0]
        whole = np_out(loop.gather(rest))
        res["gather_calls"] = np.array(calls[0] - before)
    finally:
        FleetMesh.all_gather = plain
    res.update({f"out/{k}": v for k, v in whole.items()})
    return res


CASES = {
    **{f"loop-{mode}-{b}": (lambda m, d, _b=b, _mode=mode: loop_run(_b, _mode, m))
       for mode in LOOP_MODES for b in (6, 8)},
    "chunked-8": lambda m, d: chunked_run(8, m),
    **{f"carry-{mode}-{b}": (lambda m, d, _b=b, _mode=mode: carry_shards(_b, _mode, m))
       for mode in LOOP_MODES for b in (6, 8)},
    "decide-8": lambda m, d: decide_run(8, False, m),
    "decide-compact-8": lambda m, d: decide_run(8, True, m),
    "runner-6": lambda m, d: runner_reports(6, m),
    "plans": lambda m, d: plan_takes(m),
    "fleet-session": lambda m, d: fleet_session_plans(m),
    "soak": lambda m, d: soak_runs(d, m),
    "checkpoint": lambda m, d: checkpoint_layouts(d, m),
}


def _rank_main(rank: int, world: int, out_dir: str, cases: tuple) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)  # the ranks share the host's cores
    out = pathlib.Path(out_dir)
    dist.init_process_group("gloo", init_method=(out / "store").as_uri(),
                            world_size=world, rank=rank)
    try:
        mesh = fleet_mesh(world, device="cpu")
        for name in cases:
            np.savez(out / f"r{rank}-{name}.npz", **CASES[name](mesh, out))
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, cases, out_dir: pathlib.Path, timeout: float = 240.0) -> dict:
    """Run ``cases`` on ``world`` gloo ranks; ``{rank: {case: results}}``."""
    import torch.multiprocessing as mp

    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    ctx = mp.spawn(_rank_main, args=(world, str(out_dir), tuple(cases)), nprocs=world,
                   join=False)
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} mesh ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    res = {}
    for rank in range(world):
        res[rank] = {}
        for name in cases:
            with np.load(out_dir / f"r{rank}-{name}.npz") as z:
                res[rank][name] = {k: z[k] for k in z.files}
    return res


def assert_outs_match(ref: dict, got: dict, rtol: float = 1e-6) -> None:
    """Every key of ``ref`` in ``got``: :data:`EXACT` keys bitwise,
    :data:`CLOSE` keys within ``rtol`` (NaN where ``ref`` has NaN)."""
    assert set(ref) == set(got), set(ref) ^ set(got)
    for key in ref:
        a, b = np.asarray(ref[key]), np.asarray(got[key])
        if key in CLOSE:
            np.testing.assert_allclose(b, a, rtol=rtol, equal_nan=True, err_msg=key)
        else:
            assert key in EXACT, key
            np.testing.assert_array_equal(b, a, err_msg=key)
