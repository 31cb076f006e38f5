"""The port's checkpointed soak against its straight run and the JAX
package's soak.

A stitched run -- a crash, a ``CheckpointStore`` restore and a freshly
built loop every ``checkpoint_every`` windows -- equals the straight run
bit for bit on the CPU, in float64 and float32, reactive, proactive and
compacted (``repriced`` is the one key left out).  The composite day and
its scenario are the reference's bit for bit; the port's float32 run
equals the JAX run on codes / k / applied, its floats within the bounds
the port already holds the fused loop to (``test_torch_slice.py``), and
the reports' summaries agree."""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

import _torch_mesh_ranks as ranks
from repro.streaming import soak as jsoak
from repro_torch.distributed import FleetMesh
from repro_torch.streaming import soak
from repro_torch.streaming.soak import (
    SoakConfig,
    assert_bit_identical,
    build_scenario,
    composite_day_samples,
    run_checkpointed,
    run_straight,
    soak_report,
)

MODES = {"reactive": {}, "proactive": {"proactive": True}, "compact": {"compact": True}}
DTYPES = {"float64": torch.float64, "float32": torch.float32}


@functools.lru_cache(maxsize=None)
def _straight(mode: str, dtype: str) -> dict:
    return run_straight(SoakConfig.smoke(), device="cpu", dtype=DTYPES[dtype], **MODES[mode])


@functools.lru_cache(maxsize=None)
def _jax_straight(mode: str) -> dict:
    return jsoak.run_straight(jsoak.SoakConfig.smoke(), **MODES[mode])


@pytest.mark.parametrize("cfg", [SoakConfig.smoke(), SoakConfig()], ids=["smoke", "day"])
def test_composite_day_and_scenario_equal_the_reference(cfg):
    jcfg = jsoak.SoakConfig(**dataclasses.asdict(cfg))
    np.testing.assert_array_equal(composite_day_samples(cfg), jsoak.composite_day_samples(jcfg))
    got, want = build_scenario(cfg), jsoak.build_scenario(jcfg)
    assert got.graph.names == want.graph.names
    np.testing.assert_array_equal(got.graph.routing_matrix(), want.graph.routing_matrix())
    np.testing.assert_array_equal(got.graph.lam0_vector(), want.graph.lam0_vector())
    assert got.t_max == want.t_max
    assert got.traces["ingest"].samples == want.traces["ingest"].samples
    for key in ("name", "seed", "horizon", "warmup", "dt", "k_max", "queue_capacity"):
        assert getattr(got, key) == getattr(want, key), key
    assert cfg.n_ticks == jcfg.n_ticks


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_soak_smoke_checkpoint_roundtrip_is_bit_identical(tmp_path, mode, dtype):
    """Three crashes and restores over the 60 windows of the two-hour day:
    the stitched run equals the straight one on every output."""
    cfg = SoakConfig.smoke()
    ref = _straight(mode, dtype)
    timings = {}
    chk = run_checkpointed(cfg, tmp_path / "ckpt", device="cpu", dtype=DTYPES[dtype],
                           timings=timings, **MODES[mode])
    assert chk["n_restores"] == 3
    assert len(timings["restore"]) == 3 and len(timings["run"]) == 4
    assert_bit_identical(ref, chk)
    rep = soak_report(cfg, chk)
    assert rep.n_restores == 3
    assert rep.k_total.max() <= cfg.k_max
    if mode == "compact":
        # The memo lives outside the state: the diagnostic is not stitched,
        # and the compacted day is the dense day bit for bit.
        assert "repriced" in ref and "repriced" not in chk
        assert ref["repriced"].shape == (cfg.n_ticks, 1)
        assert_bit_identical(_straight("reactive", dtype), ref)
    if mode == "proactive":
        assert int(ref["mpc_used"].sum()) > 0
        assert len(set(rep.k_total.tolist())) > 1
    if mode == "reactive":
        lo, hi = int(0.30 * cfg.day / cfg.tick_interval), int(0.35 * cfg.day / cfg.tick_interval)
        assert rep.miss[lo:hi + 1].any()
        assert 0.0 < rep.deadline_miss_rate < 0.5
        assert 0.0 <= rep.drop_rate < 0.05
        assert (ref["codes"][:, 0] != 0).any()


@pytest.mark.parametrize("mode", ["reactive", "proactive"])
def test_float32_soak_equals_the_jax_soak(mode):
    """The port's float32 day against the JAX day: decisions exact; the
    window's aggregates within rtol 1e-6 (atol 1e-6), as test_torch_slice
    holds the fused loop.  The three E[T] surfaces (the measured
    ``sojourn``, the decide's ``et_cur`` / ``et_target``) are held to rtol
    1e-5, the port's bound for float32 E[T] near saturation
    (test_torch_modules::test_decide_matches_make_decide_jax): at tick 19,
    a 5.8 s window next to saturation, the few-ulp differences of XLA's
    FMA-contracted window and LAPACK solve grow to 21 ulps (1.7e-6) of
    ``sojourn`` and 2.9e-6 of ``et_cur``; every other tick is within 2e-7."""
    got, want = _straight(mode, "float32"), _jax_straight(mode)
    exact = ("codes", "k", "applied", "k_final", "miss", "warm_windows")
    exact += ("mpc_used", "confident") if mode == "proactive" else ()
    for key in exact:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    for key in ("q_final", "offered", "served", "dropped", "ext_admitted", "ext_offered",
                "q_int", "q_max"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=1e-6, atol=1e-6,
                                   equal_nan=True, err_msg=key)
    for key in ("sojourn", "et_cur", "et_target"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=1e-5, equal_nan=True,
                                   err_msg=key)
    mine = soak_report(SoakConfig.smoke(), got).summary()
    ref = jsoak.soak_report(jsoak.SoakConfig.smoke(), want).summary()
    assert set(mine) == set(ref)
    for key, value in ref.items():
        assert mine[key] == pytest.approx(value, rel=1e-6), key


def test_soak_refuses_a_mesh(tmp_path):
    """What the sharded soak still refuses: a mesh that is not a 1-D fleet
    mesh (the reference's message for a 2-D one)."""
    cfg = SoakConfig.smoke()
    two_d = FleetMesh(group=None, size=1, rank=0, device=torch.device("cpu"),
                      axis_names=("a", "b"))
    with pytest.raises(ValueError, match="controller mesh must be 1-D"):
        run_straight(cfg, device="cpu", mesh=two_d)
    with pytest.raises(ValueError, match="FleetMesh"):
        run_checkpointed(cfg, tmp_path, device="cpu", mesh=object())


def test_sharded_soak_stitched_equals_straight_and_the_unsharded_day(tmp_path):
    """The two-hour day on two gloo ranks (B = 1 padded to one lane per
    rank): on every rank the stitched run (three crashes and restores, the
    first rank writing the checkpoints) equals the straight run bitwise,
    and both equal the unsharded day."""
    res = ranks.run_ranks(2, ("soak",), tmp_path)
    ref = _straight("reactive", "float32")
    for rank, out in res.items():
        got = out["soak"]
        straight = {k[len("straight/"):]: v for k, v in got.items() if k.startswith("straight/")}
        stitched = {k[len("stitched/"):]: v for k, v in got.items() if k.startswith("stitched/")}
        assert int(stitched.pop("n_restores")) == 3, rank
        assert set(straight) == set(ref)
        assert_bit_identical(straight, stitched)
        assert_bit_identical(ref, straight)


def test_soak_keys_are_the_references():
    for name in ("PER_TICK_KEYS", "SUMMED_KEYS", "AGGREGATE_KEYS", "DIAGNOSTIC_KEYS"):
        assert getattr(soak, name) == getattr(jsoak, name), name


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


CARD_MODES = {**MODES, "fused": {"fused_decide": True},
              "proactive-fused": {"proactive": True, "fused_decide": True}}


@pytest.mark.parametrize("mode", sorted(CARD_MODES))
def test_cuda_soak_roundtrip_and_card_vs_cpu(tmp_path, cuda_device, mode):
    """On the card: the stitched two-hour day equals the straight one bit
    for bit, and the card's decisions equal the CPU's in float32.  The
    fused decide at B = 1 too: the planner's allocator repeats a single
    lane's rows, which must reach the kernel contiguous."""
    cfg = SoakConfig.smoke()
    ref = run_straight(cfg, device=cuda_device, **CARD_MODES[mode])
    chk = run_checkpointed(cfg, tmp_path, device=cuda_device, **CARD_MODES[mode])
    assert_bit_identical(ref, chk)
    cpu = run_straight(cfg, device="cpu", **CARD_MODES[mode])
    for key in ("codes", "k"):
        np.testing.assert_array_equal(ref[key], cpu[key], err_msg=key)
