"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the CUDA device unless told otherwise."""

from __future__ import annotations

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def test_port_and_chip_smoke_load_no_jax_and_no_repro():
    code = (
        "import sys, runpy\n"
        "import repro_torch, repro_torch.convert, repro_torch.api.session\n"
        "import repro_torch.streaming.scenarios, repro_torch.core.controller\n"
        "import repro_torch.kernels.decide_fused.ops, repro_torch.kernels.gain_topr.ops\n"
        "import repro_torch.kernels.erlang_c.ops, repro_torch.kernels.queue_step.ops\n"
        "import repro_torch.kernels.l2_match.ops, repro_torch.streaming.apps.vld\n"
        "import repro_torch.streaming.engine, repro_torch.core.scheduler\n"
        "import repro_torch.core.measurer, repro_torch.core.negotiator\n"
        "import repro_torch.core.rebalance, repro_torch.api.graph\n"
        "import repro_torch.configs, repro_torch.configs.llama3_2_1b\n"
        "import repro_torch.models.common, repro_torch.models.attention\n"
        "import repro_torch.models.ffn, repro_torch.models.transformer\n"
        "import repro_torch.models.serve, repro_torch.serving.pipeline\n"
        "import repro_torch.kernels.flash_attention.ops\n"
        "import repro_torch.kernels.decode_attention.ops, repro_torch.kernels.swiglu.ops\n"
        "import repro_torch.kernels.rwkv6_scan.ops, repro_torch.kernels.ssd_scan.ops\n"
        "import repro_torch.models.ssm, repro_torch.configs.rwkv6_1_6b\n"
        "import repro_torch.configs.zamba2_7b\n"
        "import repro_torch.streaming.des, repro_torch.serving.router\n"
        "import repro_torch.forecast, repro_torch.distributed\n"
        "import repro_torch.distributed.sharding\n"
        "import repro_torch.checkpoint, repro_torch.streaming.soak\n"
        "import repro_torch.core.planner, repro_torch.core.heterogeneous\n"
        "import repro_torch.streaming.apps.fpd, repro_torch.api\n"
        "import repro_torch.core, repro_torch.streaming, repro_torch.models\n"
        "import repro_torch.serving, repro_torch.data, repro_torch.training\n"
        "import repro_torch.distributed.compress, repro_torch.configs.shapes\n"
        "import repro_torch.launch.serve, repro_torch.launch.train, repro_torch.tree\n"
        f"runpy.run_path({str(ROOT / 'chip_smoke.py')!r}, run_name='chip_smoke_import')\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(ROOT), timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_sources_have_no_jax_or_repro_imports():
    offenders = []
    for path in [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [(path.name, n) for n in names
                          if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert offenders == []


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _small_fleet():
    from repro_torch.streaming.scenarios import scenario_matrix

    return [s.with_(negotiated=False)
            for s in scenario_matrix(2, seed=1, horizon=10.0, warmup=2.0, dt=0.05)]


def test_entry_points_default_to_the_card_and_raise_without_one(no_cuda):
    from repro_torch.api.session import DRSSession, FleetSession, ScenarioRunner
    from repro_torch.convert import from_reference
    from repro_torch.core import controller as ctl
    from repro_torch.core.batched import expected_sojourn_batch, solve_traffic_batch
    from repro_torch.core.planner import FleetPlanner, Tenant
    from repro_torch.streaming.apps.fpd import FPDConfig, SlidingWindowState, build_fpd_graph
    from repro_torch.streaming.apps.vld import VLDConfig, build_vld_graph, logo_library
    from repro_torch.streaming.soak import SoakConfig, run_checkpointed, run_straight
    from repro_torch.streaming.batchsim import BatchQueueSim
    from repro_torch.streaming.engine import Operator, StreamEngine
    from repro_torch.streaming.scenarios import control_trace, scenario_matrix

    scens = _small_fleet()
    negotiated = scenario_matrix(7, seed=1, horizon=10.0, warmup=2.0, dt=0.05)[5:]
    top = scens[0].mean_topology()
    k = scens[0].plan_k0()[None]
    vld_cfg = VLDConfig()
    vld_graph, _ = build_vld_graph(vld_cfg, logo_library(vld_cfg), device="cpu")
    runner = ScenarioRunner(scens, tick_interval=5.0, device="cpu")
    st, pr = runner.static, runner.params
    planner = FleetPlanner([Tenant("a", topology=top)], 40)
    tenants = {"a": vld_graph.bind(), "b": scens[1].graph.bind()}
    soak_cfg = SoakConfig(day=240.0, checkpoint_every=1)
    calls = [
        lambda: ScenarioRunner(scens, tick_interval=5.0),
        lambda: ScenarioRunner(negotiated, tick_interval=5.0, backend="torch"),
        lambda: control_trace(scens, tick_interval=5.0),
        lambda: control_trace(negotiated, tick_interval=5.0),
        lambda: BatchQueueSim(runner.arrays),
        lambda: expected_sojourn_batch(top, k),
        lambda: solve_traffic_batch(np.ones((1, top.n)), top.routing),
        lambda: ctl.make_fused_loop(runner.arrays, st, pr, steps_per_tick=100),
        lambda: ctl.make_decide(st, pr),
        lambda: from_reference(runner.arrays, st, pr, runner.k),
        lambda: build_vld_graph(vld_cfg, logo_library(vld_cfg)),
        lambda: DRSSession.bind(vld_graph, "engine"),
        lambda: vld_graph.bind("engine"),
        lambda: StreamEngine([Operator("a", lambda x: [])]),
        lambda: run_straight(soak_cfg),
        lambda: run_checkpointed(soak_cfg, "unused"),
        lambda: planner.plan_batched(),
        lambda: FleetSession(tenants, k_max=40, solver="batched"),
        lambda: build_fpd_graph(FPDConfig()),
        lambda: SlidingWindowState(FPDConfig()),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_serving_entry_points_default_to_the_card_and_raise_without_one(no_cuda):
    _serving_calls_raise_without_a_card("llama3.2-1b")


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b"])
def test_ssm_serving_entry_points_default_to_the_card_and_raise_without_one(no_cuda, arch):
    _serving_calls_raise_without_a_card(arch)


def _serving_calls_raise_without_a_card(arch):
    from repro_torch.configs import get_config
    from repro_torch.convert import model_params_from_reference
    from repro_torch.models import serve
    from repro_torch.models.transformer import init_params

    cfg = get_config(arch, "smoke")
    params = init_params(cfg, device="cpu")
    cache = serve.init_cache(cfg, 1, 8, device="cpu")
    tokens = np.zeros((1, 4), np.int32)
    calls = [
        lambda: init_params(cfg),
        lambda: serve.init_cache(cfg, 1, 8),
        lambda: serve.prefill(params, cfg, {"tokens": tokens}, cache),
        lambda: serve.decode_step(params, cfg, tokens[:, 0], cache),
        lambda: model_params_from_reference({"embed": np.zeros((2, 2), np.float32)}, cfg),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_runner_refuses_negotiated_scenarios():
    """The reference's gate: the fused loop cannot lease machines between
    ticks, so ``fused=True`` on a negotiated scenario raises; the
    automatic gate sends it to the window-at-a-time loop."""
    from repro_torch.api.graph import GraphValidationError
    from repro_torch.api.session import ScenarioRunner
    from repro_torch.streaming.scenarios import vld_scenario

    with pytest.raises(GraphValidationError, match="negotiated"):
        ScenarioRunner([vld_scenario()], device="cpu", fused=True)
    assert not ScenarioRunner([vld_scenario()], device="cpu").fused


def test_host_paths_run_without_a_card(no_cuda):
    """The DES (``bind``'s default backend) and the numpy twin are host
    code: they need no card and launch nothing."""
    from repro_torch.api.graph import AppGraph
    from repro_torch.api.session import DRSSession, ScenarioRunner
    from repro_torch.core.batched import expected_sojourn_batch
    from repro_torch.kernels import LAUNCHES
    from repro_torch.streaming.scenarios import scenario_matrix

    before = dict(LAUNCHES)
    graph = AppGraph.chain([("a", 5.0), ("b", 9.0)], 2.0)
    assert DRSSession.bind(graph, horizon=30.0).simulate([1, 1]).completed > 0
    assert graph.bind(horizon=30.0).backend.kind == "des"
    scens = scenario_matrix(7, seed=1, horizon=10.0, warmup=2.0, dt=0.05)
    reports = ScenarioRunner(scens, tick_interval=5.0, backend="numpy").run()
    assert len(reports) == 7 and all(len(r.actions) == 2 for r in reports)
    top = scens[0].mean_topology()
    assert np.isfinite(expected_sojourn_batch(top, scens[0].plan_k0()[None], backend="numpy")
                       ).all()
    # The scalar fleet solver and the heterogeneous allocator are host code.
    from repro_torch.api.session import FleetSession
    from repro_torch.core.heterogeneous import SpeedPool, assign_heterogeneous

    fleet = FleetSession({"a": graph.bind(), "b": AppGraph.chain([("c", 4.0)], 2.0).bind()},
                         k_max=12)
    fleet.start()
    assert fleet.tick(now=0.0).plan.total <= 12
    assert np.isfinite(assign_heterogeneous(top, SpeedPool.of({1.0: 40, 0.5: 8}))
                       .expected_sojourn)
    assert dict(LAUNCHES) == before


def test_cpu_runner_reports_are_sane():
    from repro_torch.api.session import ScenarioRunner
    from repro_torch.core.controller import ACTIONS
    from repro_torch.kernels import LAUNCHES

    before = dict(LAUNCHES)
    scens = _small_fleet()
    runner = ScenarioRunner(scens, tick_interval=5.0, device="cpu")
    reports = runner.run()
    assert dict(LAUNCHES) == before  # the CPU path never launches a kernel
    for s, r in zip(scens, reports):
        assert len(r.actions) == runner.arrays.steps // runner._steps_per_tick
        assert set(r.actions) <= set(ACTIONS)
        assert sum(r.k_final.values()) <= s.k_max
        assert np.isfinite(r.drop_rate)
