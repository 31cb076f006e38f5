"""The port's mesh-sharded control plane against the unsharded port and
the JAX package's sharded run.

* Padding (no mesh): ``pad_static`` / ``pad_params`` / ``pad_batch`` /
  ``pack_scenarios(pad_to=)`` equal the reference's arrays bitwise; padded
  lanes decide ``"none"`` in the decide and the float64 twin; a run at B +
  2 equals the run at B on the real lanes.
* Ranks: gloo process groups of 2 and 4 ranks on the CPU, spawned once per
  mesh size (``tests/_torch_mesh_ranks.py``), run the fused loop (dense,
  fused decide, ``compact``, ``proactive``), a chunked resume, the
  standalone decide (dense and compacted) and ``ScenarioRunner`` reports;
  each result is held against the unsharded port on every rank: decisions,
  allocations and integer aggregates bitwise, the E[T] diagnostics at rtol
  1e-6.  B = 8 on 2 ranks, B = 6 on 4 (two padded lanes).
* The reference: the JAX package's sharded fused loop at B = 6 on four
  emulated host devices (a subprocess under
  ``XLA_FLAGS=--xla_force_host_platform_device_count=4``), against the
  port's 4-rank run in float32: the exact keys bitwise, the E[T]
  diagnostics at rtol 1e-5.
* Refusals: a 2-D or foreign mesh, ``mesh=`` off the fused loop.
* On the card (skipped here): a one-rank NCCL mesh loop against the
  unsharded card loop.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

import _torch_mesh_ranks as ranks
import repro.core.controller as jctl
from repro.api.session import ScenarioRunner as JaxRunner
from repro.streaming.scenarios import pack_scenarios as j_pack_scenarios
from repro.streaming.scenarios import scenario_matrix as j_scenario_matrix
from repro_torch.api import GraphValidationError
from repro_torch.api.session import ScenarioRunner
from repro_torch.convert import params_from_reference, static_from_reference
from repro_torch.core import controller as ctl
from repro_torch.core.measurer import MeasurementBatch
from repro_torch.core.planner import FleetPlanner
from repro_torch.distributed import FleetMesh, fleet_backend, fleet_mesh
from repro_torch.streaming.scenarios import pack_scenarios

ROOT = pathlib.Path(__file__).resolve().parents[1]
D2_CASES = (*(f"loop-{m}-8" for m in ranks.LOOP_MODES), "chunked-8", "decide-8",
            "decide-compact-8", "runner-6", *(f"carry-{m}-8" for m in ranks.LOOP_MODES))
D4_CASES = (*(f"loop-{m}-6" for m in ranks.LOOP_MODES),
            *(f"carry-{m}-6" for m in ranks.LOOP_MODES))


@pytest.fixture(scope="module")
def d2(tmp_path_factory):
    return ranks.run_ranks(2, D2_CASES, tmp_path_factory.mktemp("mesh2"))


@pytest.fixture(scope="module")
def d4(tmp_path_factory):
    return ranks.run_ranks(4, D4_CASES, tmp_path_factory.mktemp("mesh4"))


def _every_rank(res, case):
    """Each rank's result of ``case``; every rank returns the whole fleet."""
    outs = [res[r][case] for r in sorted(res)]
    for other in outs[1:]:
        assert set(other) == set(outs[0])
        for key in outs[0]:
            np.testing.assert_array_equal(other[key], outs[0][key], err_msg=key)
    return outs[0]


# --------------------------------------------------------------------------- #
# Padding, no mesh
# --------------------------------------------------------------------------- #
def _j_scens(b, seed=11):
    return [s.with_(negotiated=False)
            for s in j_scenario_matrix(b, seed=seed, horizon=20.0, warmup=5.0, dt=0.05)]


def test_pad_static_and_params_equal_the_reference():
    jr = JaxRunner(_j_scens(3), tick_interval=5.0, backend="numpy")
    st, pr = static_from_reference(jr.static), params_from_reference(jr._params())
    want_st, want_pr = jctl.pad_static(jr.static, 5), jctl.pad_params(jr._params(), 5)
    got_st, got_pr = ctl.pad_static(st, 5), ctl.pad_params(pr, 5)
    for name in ("base_routing", "group", "alpha", "active", "speed", "n_ops"):
        np.testing.assert_array_equal(getattr(got_st, name), getattr(want_st, name), name)
    assert got_st.names == tuple(tuple(n) for n in want_st.names)
    for name in ("t_max", "k_max", "headroom", "scale_in_hysteresis", "min_improvement",
                 "horizon_seconds"):
        np.testing.assert_array_equal(getattr(got_pr, name), getattr(want_pr, name), name)
    assert got_pr.allocator == tuple(want_pr.allocator)
    assert ctl.pad_static(got_st, 5) is got_st and ctl.pad_params(got_pr, 5) is got_pr
    with pytest.raises(ValueError):
        ctl.pad_static(got_st, 4)
    with pytest.raises(ValueError):
        ctl.pad_params(got_pr, 4)


def test_pack_scenarios_pad_to_and_pad_batch_equal_the_reference():
    got = pack_scenarios(ranks.scens(3), pad_to=5)
    want = j_pack_scenarios(_j_scens(3), pad_to=5)
    for name in ("ext", "routing", "mu", "group", "alpha", "cap_queue", "active", "ca2",
                 "cs2"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.speed is None and want.speed is None
    assert (got.dt, got.warmup_steps) == (want.dt, want.warmup_steps)
    base = pack_scenarios(ranks.scens(3))
    assert base.pad_batch(3) is base
    np.testing.assert_array_equal(base.pad_batch(5).ext, got.ext)
    with pytest.raises(ValueError):
        pack_scenarios(ranks.scens(3), pad_to=2)


def test_padded_lanes_decide_none_in_the_decide_and_the_twin():
    r = ScenarioRunner(ranks.scens(3), tick_interval=5.0, device="cpu")
    b, n = 5, r.static.n
    st, pr = ctl.pad_static(r.static, b), ctl.pad_params(r.params, b)
    lam, mu, drop, lam0, k = ranks.decide_inputs(b, n, st.active)
    for fused in (False, True):
        code, k_next, _et, _tgt, applied = (
            o.numpy() for o in ctl.make_decide(st, pr, fused=fused, device="cpu")(
                lam, mu, drop, lam0, k))
        np.testing.assert_array_equal(code[3:], ctl.ACTIONS.index("none"))
        np.testing.assert_array_equal(applied[3:], False)
        np.testing.assert_array_equal(k_next[3:], k[3:])
    meas = MeasurementBatch(lam_hat=lam, mu_hat=mu, lam0_hat=lam0,
                            sojourn_hat=np.full(b, 0.5), t=0.0, drop_hat=drop)
    for row in ctl.tick_batch(meas, k.copy(), st, pr).rows[3:]:
        assert row.action == "none" and not row.applied and row.reason == "padded lane"


@pytest.mark.parametrize("mode", sorted(ranks.LOOP_MODES))
def test_padded_run_equals_the_run_at_b_on_the_real_lanes(mode):
    """B and B + 2 (two inert lanes, no mesh): the real lanes bitwise, the
    padded lanes decide "none" with zero aggregates."""
    b, pad = 4, 2
    r = ranks.runner(ranks.scens(b, 7), mode)
    ref = ranks.np_out(ranks.loop_of(r)[0](r.k))
    kw = ranks.LOOP_MODES[mode]
    proactive = ranks.mpc_cfg() if kw.get("proactive") else None
    loop, _ = ctl.make_fused_loop(
        pack_scenarios(ranks.scens(b, 7), pad_to=b + pad), ctl.pad_static(r.static, b + pad),
        ctl.pad_params(r.params, b + pad), steps_per_tick=r._steps_per_tick,
        warmup_seconds=5.0, fused=kw.get("fused_decide", False), proactive=proactive,
        compact=kw.get("compact"), device="cpu")
    got = ranks.np_out(loop(np.concatenate([r.k, np.zeros((pad, r.static.n), np.int64)])))

    def real(key, v):
        if key in PER_TICK:
            return v[:, :b]
        return v[:b] if v.ndim else v

    ranks.assert_outs_match(ref, {key: real(key, v) for key, v in got.items()})
    np.testing.assert_array_equal(got["codes"][:, b:], ctl.ACTIONS.index("none"))
    np.testing.assert_array_equal(got["applied"][:, b:], False)
    for key in ("k_final", "q_final", "offered", "served", "dropped", "q_int", "q_max",
                "miss"):
        np.testing.assert_array_equal(got[key][b:], 0, err_msg=key)


#: The loop's per-tick outputs ([ticks, B, ...]); the rest are per lane.
PER_TICK = ("codes", "k", "sojourn", "et_cur", "et_target", "applied", "mpc_used",
            "confident", "repriced", "eligible")


def test_one_rank_mesh_equals_the_unsharded_loop():
    """``fleet_mesh(1)``: the one-rank baseline, no process group and no
    collectives."""
    mesh = fleet_mesh(1, device="cpu")
    assert mesh.group is None and mesh.size == 1 and mesh.axis_names == ("fleet",)
    ranks.assert_outs_match(ranks.loop_run(5, "dense"), ranks.loop_run(5, "dense", mesh))


# --------------------------------------------------------------------------- #
# Two and four gloo ranks
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", sorted(ranks.LOOP_MODES))
def test_two_ranks_fused_loop_equals_the_unsharded_loop(d2, mode):
    ranks.assert_outs_match(ranks.loop_run(8, mode), _every_rank(d2, f"loop-{mode}-8"))


@pytest.mark.parametrize("mode", sorted(ranks.LOOP_MODES))
def test_four_ranks_padded_fused_loop_equals_the_unsharded_loop(d4, mode):
    """B = 6 on four ranks: two inert lanes of padding, cut off again."""
    ranks.assert_outs_match(ranks.loop_run(6, mode), _every_rank(d4, f"loop-{mode}-6"))


@pytest.mark.parametrize("mode", sorted(ranks.LOOP_MODES))
@pytest.mark.parametrize("world,b", [(2, 8), (4, 6)], ids=["2-ranks", "4-ranks-padded"])
def test_each_rank_keeps_its_lanes_and_a_run_gathers_nothing(request, world, b, mode):
    """Between runs every rank holds ``B_pad / D`` lanes of carry (state,
    aggregates and forecast state) and of each per-tick output; ``init``
    and ``run`` make no ``all_gather``, and ``gather`` assembles outputs
    equal to the unsharded loop's (ticks 1 onward, and the aggregates)."""
    res = request.getfixturevalue(f"d{world}")
    lanes = -(-b // world)
    want = ranks.loop_run(b, mode)
    for rank, got in res.items():
        c = got[f"carry-{mode}-{b}"]
        for when in ("init", "run1", "run2"):
            assert int(c[f"{when}_gathers"]) == 0, (rank, when)
        np.testing.assert_array_equal(c["carry_lanes"], lanes, err_msg=str(rank))
        assert c["out_lanes"].size >= 6 and (c["out_lanes"] == lanes).all(), rank
        assert int(c["gather_calls"]) > 0
        out = {k[len("out/"):]: v for k, v in c.items() if k.startswith("out/")}
        for key in PER_TICK:
            if key in out and key not in ranks.CLOSE:
                np.testing.assert_array_equal(out[key], want[key][1:], err_msg=key)
        for key in ("k_final", "q_final", "offered", "served", "dropped", "ext_admitted",
                    "ext_offered", "q_int", "q_max"):
            np.testing.assert_array_equal(out[key], want[key], err_msg=key)


def test_two_ranks_chunked_resume_equals_the_straight_run(d2):
    got = _every_rank(d2, "chunked-8")
    ranks.assert_outs_match(ranks.loop_run(8, "dense"), got)
    ranks.assert_outs_match(ranks.chunked_run(8), got)


def test_two_ranks_decide_equals_the_unsharded_decide(d2):
    want, got = ranks.decide_run(8, False), _every_rank(d2, "decide-8")
    for key in want:
        if key.startswith("et_"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_two_ranks_compacted_decide_reprices_what_the_unsharded_one_does(d2):
    """Cold (every lane), quiet (none), one lane perturbed (that lane, on
    its shard), quiet again: the outputs and the repriced lanes of the
    unsharded compacted decide, and its outputs those of the dense one."""
    want, got = ranks.decide_run(8, True), _every_rank(d2, "decide-compact-8")
    assert [int(got[f"repriced{c}"].sum()) for c in range(4)] == [8, 0, 1, 0]
    assert bool(got["repriced2"][3])
    dense = ranks.decide_run(8, False)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for c in range(4):
        np.testing.assert_array_equal(got[f"code{c}"], dense["code"])


def test_two_ranks_scenario_runner_reports_equal_the_unsharded_ones(d2):
    want = ranks.runner_reports(6)
    got = _every_rank(d2, "runner-6")
    assert set(got) == set(want)
    for key in want:
        if key.endswith("/sojourn"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6, equal_nan=True)
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# --------------------------------------------------------------------------- #
# Against the JAX package's sharded loop
# --------------------------------------------------------------------------- #
_JAX_MAIN = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4 " + os.environ.get("XLA_FLAGS", "")
import numpy as np
import repro.core.controller as ctl
from repro.api.session import ScenarioRunner
from repro.distributed.sharding import fleet_mesh
from repro.streaming.scenarios import scenario_matrix

scens = [s.with_(negotiated=False)
         for s in scenario_matrix(6, seed=11, horizon=20.0, warmup=5.0, dt=0.05)]
for fused in (False, True):
    r = ScenarioRunner(scens, tick_interval=5.0, backend="jax", fused_decide=fused,
                       mesh=fleet_mesh(4))
    loop, _ = ctl.make_fused_loop(r.arrays, r.static, r._params(),
                                  steps_per_tick=r._steps_per_tick, warmup_seconds=5.0,
                                  mesh=fleet_mesh(4))
    out = {k: np.asarray(v) for k, v in loop(r.k).items()}
    np.savez(os.path.join(sys.argv[1], f"jax-{'fused' if fused else 'dense'}.npz"), **out)
"""


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_mesh")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_MAIN, str(out)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    res = {}
    for mode in ("dense", "fused"):
        with np.load(out / f"jax-{mode}.npz") as z:
            res[mode] = {k: z[k] for k in z.files}
    return res


@pytest.mark.parametrize("mode", ["dense", "fused"])
def test_four_ranks_equal_the_jax_sharded_loop(d4, jax_sharded, mode):
    """The port's 4-rank run and the JAX package's 4-device run of the same
    six scenarios in float32 (each also equals its own unsharded run).
    Decisions, allocations and counts bitwise.  The window's float
    aggregates at rtol 1e-6 (atol 1e-6), as test_torch_slice holds the two
    loops: XLA and PyTorch round the routing product differently, here by
    up to 1e-7.  The E[T] diagnostics at rtol 1e-5 (ROADMAP Queue 3,
    "Float32 E[T] diagnostics"), but for ``et_cur`` on the lanes where
    JAX's float32 LU solve of a near-singular traffic system returns NaN
    (both decide "infeasible"): there the port's solve keeps the float64
    rates (~3e8) and prices the current allocation at inf, the reference
    masks its NaN rates and reports 0 (ROADMAP Queue 3)."""
    want = jax_sharded[mode]
    got = _every_rank(d4, f"loop-{mode}-6")
    assert set(got) == set(want)
    for key in ("codes", "k", "applied", "k_final", "miss", "warm_windows"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("q_final", "offered", "served", "dropped", "ext_admitted", "ext_offered",
                "q_int", "q_max"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-6, err_msg=key)
    for key in ("sojourn", "et_target"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, equal_nan=True, err_msg=key)
    nan_solve = (want["codes"] == ctl.ACTIONS.index("infeasible")) & (want["et_cur"] == 0) & (
        got["et_cur"] != 0)
    assert np.isinf(got["et_cur"][nan_solve]).all()
    np.testing.assert_allclose(got["et_cur"][~nan_solve], want["et_cur"][~nan_solve], rtol=1e-5,
                               equal_nan=True)
    assert len(set(want["codes"].ravel().tolist())) >= 2


# --------------------------------------------------------------------------- #
# What is refused
# --------------------------------------------------------------------------- #
def _two_d_mesh():
    return FleetMesh(group=None, size=1, rank=0, device=torch.device("cpu"),
                     axis_names=("a", "b"))


class _ForeignMesh:
    axis_names = ("fleet",)
    size = 1


@pytest.mark.parametrize("mesh,match", [(_two_d_mesh(), "must be 1-D"),
                                        (_ForeignMesh(), "FleetMesh")],
                         ids=["2-D", "foreign"])
def test_controller_refuses_a_mesh_that_is_not_a_fleet_mesh(mesh, match):
    r = ScenarioRunner(ranks.scens(2), tick_interval=5.0, device="cpu")
    with pytest.raises(ValueError, match=match):
        ctl._mesh_axis(mesh)
    with pytest.raises(ValueError, match=match):
        ctl.make_decide(r.static, r.params, mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match=match):
        ranks.loop_of(r, mesh)
    with pytest.raises(ValueError, match=match):
        FleetPlanner(ranks.chain_tenants(), 220).plan_batched(mesh=mesh, device="cpu")


def test_scenario_runner_mesh_needs_the_fused_loop():
    mesh = fleet_mesh(1, device="cpu")
    with pytest.raises(GraphValidationError, match="window-at-a-time"):
        ScenarioRunner(ranks.scens(2), tick_interval=5.0, fused=False, mesh=mesh,
                       device="cpu")
    with pytest.raises(GraphValidationError, match="window-at-a-time"):
        ScenarioRunner(ranks.scens(2), tick_interval=5.0, backend="numpy", mesh=mesh)


def test_fleet_mesh_without_a_process_group():
    with pytest.raises(ValueError, match="no process group"):
        fleet_mesh(2, device="cpu")
    with pytest.raises(ValueError, match=">= 1 rank"):
        fleet_mesh(0, device="cpu")
    mesh = fleet_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.axis_names) == (1, 0, ("fleet",))
    assert mesh.shard(6) == slice(0, 6)
    with pytest.raises(ValueError, match="multiple"):
        FleetMesh(group=None, size=4, rank=1, device=torch.device("cpu")).shard(6)
    assert FleetMesh(group=None, size=4, rank=1, device=torch.device("cpu")).shard(8) == \
        slice(2, 4)


def test_fleet_backend_rule():
    """NCCL only where each rank has a card of its own."""
    assert fleet_backend("cpu", 4) == "gloo"
    cards = torch.cuda.device_count()
    assert fleet_backend("cuda", cards + 1) == "gloo"
    if cards:
        assert fleet_backend("cuda", cards) == "nccl"


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("mode", ["dense", "fused"])
def test_cuda_one_rank_nccl_mesh_loop_equals_the_unsharded_card_loop(cuda_device, mode):
    import torch.distributed as dist

    sc = ranks.scens(6)
    kw = ranks.LOOP_MODES[mode]

    def run(mesh):
        r = ScenarioRunner(sc, tick_interval=5.0, mesh=mesh, device=cuda_device, **kw)
        r.run()
        return r.outputs

    want = run(None)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=(pathlib.Path(tmp) / "store").as_uri(),
                                world_size=1, rank=0)
        try:
            mesh = fleet_mesh()
            assert mesh.backend == "nccl" and mesh.device.type == "cuda"
            got = run(mesh)
        finally:
            dist.destroy_process_group()
    ranks.assert_outs_match(want, got)
