"""The port's CheckpointStore: every case of ``tests/test_checkpoint.py``
that needs no mesh, on torch trees; both directions across the packages
(the JAX store's directory restored by the port, and the port's by the JAX
store, leaf for leaf, bfloat16 and float8 included); and the in-place
hazard of the fused loop's state (a snapshot taken before the next run
writes into the buffers)."""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as _ranks
import repro.core.controller as jctl
from repro.api.session import ScenarioRunner as JaxRunner
from repro.checkpoint.store import CheckpointStore as JaxStore
from repro.streaming.scenarios import scenario_matrix
from repro_torch.checkpoint import CheckpointStore
from repro_torch.convert import controller_state_from_reference, from_reference
from repro_torch.core import controller as ctl


def tree(seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((8, 4), generator=g).to(dtype),
                   "b": torch.zeros((4,), dtype=dtype)},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def test_save_restore_roundtrip(tmp_path):
    st = CheckpointStore(tmp_path)
    t = tree()
    st.save(10, t, extra={"data": {"step": 10}})
    out, extra = st.restore(t)
    assert torch.equal(out["params"]["w"], t["params"]["w"])
    assert out["params"]["w"].data_ptr() != t["params"]["w"].data_ptr()
    assert out["step"].dtype == torch.int32 and int(out["step"]) == 7
    assert extra["data"]["step"] == 10
    assert st.latest_step() == 10


def test_bfloat16_roundtrip(tmp_path):
    st = CheckpointStore(tmp_path)
    t = tree(dtype=torch.bfloat16)
    st.save(1, t)
    out, _ = st.restore(t)
    assert out["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(out["params"]["w"].view(torch.int16), t["params"]["w"].view(torch.int16))


def test_dtype_cast_on_restore(tmp_path):
    """A float32 checkpoint restores onto a bfloat16 template."""
    st = CheckpointStore(tmp_path)
    t32 = tree(dtype=torch.float32)
    st.save(1, t32)
    t16 = {"params": {k: v.to(torch.bfloat16) for k, v in t32["params"].items()},
           "step": t32["step"]}
    out, _ = st.restore(t16)
    assert out["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(out["params"]["w"], t32["params"]["w"].to(torch.bfloat16))


def test_async_save_then_wait(tmp_path):
    st = CheckpointStore(tmp_path)
    st.save_async(5, tree())
    st.wait()
    assert st.latest_step() == 5


def test_shape_mismatch_raises(tmp_path):
    st = CheckpointStore(tmp_path)
    st.save(1, tree())
    bad = tree()
    bad["params"]["w"] = torch.zeros((9, 4))
    with pytest.raises(ValueError, match="shape mismatch"):
        st.restore(bad)


def test_prune_keeps_newest(tmp_path):
    st = CheckpointStore(tmp_path)
    for s in (1, 2, 3, 4, 5):
        st.save(s, tree())
    assert st.prune(keep=2) == 3
    assert st.latest_step() == 5
    with pytest.raises(Exception):
        st.restore(tree(), step=1)


def test_atomic_overwrite(tmp_path):
    st = CheckpointStore(tmp_path)
    st.save(1, tree(seed=0))
    st.save(1, tree(seed=1))
    out, _ = st.restore(tree(), step=1)
    assert torch.equal(out["params"]["w"], tree(seed=1)["params"]["w"])
    assert not list(tmp_path.glob("*.tmp"))


@pytest.mark.parametrize("name", ["float8_e4m3fn", "float8_e5m2"])
def test_float8_roundtrip(tmp_path, name):
    """float8 leaves save as uint8 carriers and restore with the logical
    dtype and the exact bit pattern."""
    dt = getattr(torch, name)
    st = CheckpointStore(tmp_path)
    t = {"w": torch.arange(-8, 8, dtype=torch.float32).to(dt), "step": torch.tensor(3)}
    st.save(1, t)
    out, _ = st.restore(t)
    assert out["w"].dtype == dt
    assert torch.equal(out["w"].view(torch.uint8), t["w"].view(torch.uint8))


def test_namedtuple_and_forecast_state_roundtrip(tmp_path):
    """A carry shaped like the fused loop's: a NamedTuple with mixed
    dtypes, a nested aggregate tuple, the forecast state, a host int."""
    from repro_torch.forecast.mpc import MPCConfig, forecast_init_state_torch

    class Carry(NamedTuple):
        q: torch.Tensor
        k: torch.Tensor
        acc: tuple
        tick: int
        fstate: tuple

    g = torch.Generator().manual_seed(5)
    fstate = forecast_init_state_torch(2, 3, MPCConfig(window=6), dtype=torch.float64,
                                       device="cpu")
    carry = Carry(q=torch.rand((2, 3), generator=g, dtype=torch.float64) * 9,
                  k=torch.randint(1, 8, (2, 3), generator=g, dtype=torch.int32),
                  acc=(torch.rand((2, 3), generator=g), torch.rand((2, 3), generator=g)),
                  tick=4, fstate=fstate)
    st = CheckpointStore(tmp_path)
    st.save(4, carry)
    out, _ = st.restore(carry)
    assert type(out) is Carry
    assert torch.equal(out.q, carry.q) and torch.equal(out.k, carry.k)
    assert out.k.dtype == torch.int32
    assert out.tick == 4 and type(out.tick) is int
    for got, want in zip(out.acc, carry.acc):
        assert torch.equal(got, want)
    assert len(out.fstate) == len(fstate) > 0
    for got, want in zip(out.fstate, fstate):
        assert torch.equal(got, want)


def test_async_save_ordering_one_in_flight(tmp_path):
    st = CheckpointStore(tmp_path)
    trees = {s: tree(seed=s) for s in (1, 2, 3)}
    for s, t in trees.items():
        st.save_async(s, t)
    st.wait()
    assert st.save_count == 3
    assert st.latest_step() == 3
    for s, t in trees.items():
        out, _ = st.restore(tree(), step=s)
        assert torch.equal(out["params"]["w"], t["params"]["w"])
    st.wait()


def test_latest_step_ignores_partial_and_corrupt_dirs(tmp_path):
    st = CheckpointStore(tmp_path)
    t = tree()
    st.save(3, t)
    (tmp_path / "step_0000000009").mkdir()
    (tmp_path / "step_0000000007.tmp").mkdir()
    (tmp_path / "step_garbage").mkdir()
    assert st.latest_step() == 3
    out, _ = st.restore(t)
    assert torch.equal(out["params"]["w"], t["params"]["w"])


# --------------------------------------------------------------------------- #
# The fused loop's state: resume bit-identical, the in-place hazard
# --------------------------------------------------------------------------- #
def _scens():
    return [s.with_(negotiated=False)
            for s in scenario_matrix(4, seed=19, horizon=20.0, warmup=5.0, dt=0.05)]


def _port_loop(proactive=None, dtype=torch.float64):
    from repro_torch.api.session import ScenarioRunner
    from repro_torch.convert import mpc_config_from_reference, scenario_from_reference

    r = ScenarioRunner([scenario_from_reference(s) for s in _scens()], tick_interval=5.0,
                       device="cpu", dtype=dtype,
                       proactive=None if proactive is None else
                       mpc_config_from_reference(proactive))
    loop, n_ticks = ctl.make_fused_loop(
        r.arrays, r.static, r._params(), steps_per_tick=r._steps_per_tick,
        warmup_seconds=5.0, proactive=r.proactive_cfg, device="cpu", dtype=dtype,
    )
    return r, loop, n_ticks


def _mpc():
    from repro.forecast.mpc import MPCConfig, PredictorParams

    return MPCConfig(horizon=3, window=12, min_scored=2,
                     predictor=PredictorParams(kind="holt", alpha=0.6, beta=0.4))


@pytest.mark.parametrize("proactive", [False, True], ids=["reactive", "proactive"])
def test_controller_state_checkpoint_resume_bit_identical(tmp_path, proactive):
    """Save the state mid-horizon, restore into a fresh loop, run the rest:
    outputs equal a straight-through run bit for bit (the forecast state's
    leaves included)."""
    cfg = _mpc() if proactive else None
    r, loop, n_ticks = _port_loop(cfg)
    ref = {k: np.asarray(v) for k, v in loop(r.k).items()}
    r2, loop2, _ = _port_loop(cfg)
    state, _ = loop2.run(loop2.init(r2.k), 2)
    st = CheckpointStore(tmp_path)
    st.save(2, state)
    r3, loop3, _ = _port_loop(cfg)
    restored, _ = st.restore(loop3.init(r3.k), step=2)
    restored = ctl.ControllerState(*restored)
    assert restored.tick == 2
    assert len(restored.fstate) == (7 if proactive else 0)
    _, out = loop3.run(restored)
    for key in ("codes", "k", "applied") + (("mpc_used",) if proactive else ()):
        np.testing.assert_array_equal(out[key].numpy(), ref[key][2:], err_msg=key)
    for key in ("k_final", "q_final", "offered", "served", "dropped", "ext_admitted",
                "ext_offered", "q_int", "q_max"):
        np.testing.assert_array_equal(out[key].numpy(), ref[key], err_msg=key)


def test_save_async_snapshot_survives_the_next_run(tmp_path):
    """The loop updates its state in place (``acc``), and on the CPU a
    tensor's numpy view aliases it: ``save_async`` must copy before it
    returns, so the checkpoint on disk is the tick it was saved at even when
    the loop runs on while the writer thread is still saving."""
    import threading

    gate = threading.Event()

    class HeldStore(CheckpointStore):
        """The writer thread starts writing only once the loop ran on."""

        def _write(self, *args):
            gate.wait(timeout=60)
            return super()._write(*args)

    r, loop, _ = _port_loop(dtype=torch.float32)
    state, _ = loop.run(loop.init(r.k), 1)
    frozen = [a.clone() for a in state.acc]
    st = HeldStore(tmp_path)
    st.save_async(1, state)
    later, _ = loop.run(state, 2)  # writes into the same acc buffers
    gate.set()
    st.wait()
    assert any(not torch.equal(a, f) for a, f in zip(later.acc, frozen))
    restored, _ = st.restore(loop.init(r.k), step=1)
    restored = ctl.ControllerState(*restored)
    assert restored.tick == 1
    for got, want in zip(restored.acc, frozen):
        assert torch.equal(got, want)
    assert all(g.data_ptr() != w.data_ptr() for g, w in zip(restored.acc, later.acc))


# --------------------------------------------------------------------------- #
# Across the packages
# --------------------------------------------------------------------------- #
@functools.lru_cache(maxsize=2)
def _jax_state(proactive):
    """A JAX loop's state after 2 ticks (with its forecast state when
    proactive), in float32."""
    runner = JaxRunner(_scens(), tick_interval=5.0, backend="numpy", fused=False,
                       proactive=_mpc() if proactive else None)
    loop, _ = jctl.make_fused_loop(runner.arrays, runner.static, runner._params(),
                                   steps_per_tick=runner._steps_per_tick,
                                   proactive=runner.proactive_cfg)
    state, _ = loop.run(loop.init(runner.k), 2)
    return runner, state


def _exotic_leaves(rng):
    x = rng.normal(size=(3, 5)).astype(np.float32)
    return {name: x.astype(getattr(ml_dtypes, name))
            for name in ("bfloat16", "float8_e4m3fn", "float8_e5m2")}


@pytest.mark.parametrize("proactive", [False, True], ids=["reactive", "proactive"])
def test_port_restores_the_jax_stores_directory(tmp_path, proactive):
    runner, jstate = _jax_state(proactive)
    exotic = _exotic_leaves(np.random.default_rng(1))
    JaxStore(tmp_path).save(2, {"state": jstate, "exotic": exotic})
    template = {
        "state": from_reference(runner.arrays, runner.static, runner._params(), runner.k,
                                device="cpu")[3],
        "exotic": {k: torch.zeros(v.shape, dtype=getattr(torch, k)) for k, v in exotic.items()},
    }
    if proactive:
        template["state"] = template["state"]._replace(
            fstate=controller_state_from_reference(jstate, device="cpu").fstate)
    out, _ = CheckpointStore(tmp_path).restore(template, step=2)
    want = controller_state_from_reference(jstate, device="cpu")
    got = ctl.ControllerState(*out["state"])
    assert got.tick == 2 and len(got.fstate) == len(jstate.fstate) == (7 if proactive else 0)
    for g, w in zip(_leaves(got), _leaves(want)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    for name, arr in exotic.items():
        assert out["exotic"][name].dtype == getattr(torch, name)
        carrier = np.uint16 if name == "bfloat16" else np.uint8
        np.testing.assert_array_equal(
            out["exotic"][name].view(torch.int16 if name == "bfloat16" else torch.uint8)
            .numpy().view(carrier), arr.view(carrier))


@pytest.mark.parametrize("proactive", [False, True], ids=["reactive", "proactive"])
def test_jax_store_restores_the_ports_directory(tmp_path, proactive):
    runner, jstate = _jax_state(proactive)
    state = controller_state_from_reference(jstate, device="cpu")
    g = torch.Generator().manual_seed(2)
    exotic = {name: torch.randn((3, 5), generator=g).to(getattr(torch, name))
              for name in ("bfloat16", "float8_e4m3fn", "float8_e5m2")}
    CheckpointStore(tmp_path).save(2, {"state": state, "exotic": exotic})
    template = {"state": jstate,
                "exotic": {k: np.zeros(v.shape, getattr(ml_dtypes, k)) for k, v in exotic.items()}}
    out, _ = JaxStore(tmp_path).restore(template, step=2)
    got = jctl.ControllerState(*out["state"])
    assert int(got.tick) == 2
    for gl, wl in zip(_leaves(got), _leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(gl), np.asarray(wl))
        assert np.asarray(gl).dtype == np.asarray(wl).dtype
    for name, t in exotic.items():
        carrier = (torch.int16, np.uint16) if name == "bfloat16" else (torch.uint8, np.uint8)
        assert out["exotic"][name].dtype == getattr(ml_dtypes, name)
        np.testing.assert_array_equal(np.asarray(out["exotic"][name]).view(carrier[1]),
                                      t.view(carrier[0]).numpy().view(carrier[1]))


def _leaves(state):
    return [state.q, state.served_prev, state.k, *state.acc, *state.fstate]


def test_port_keys_equal_the_jax_stores_keys(tmp_path):
    """Both stores name the state's leaves alike: q, served_prev, k,
    acc/0..6, tick, fstate/0..6."""
    import json

    _, jstate = _jax_state(True)
    JaxStore(tmp_path / "jax").save(1, jstate)
    CheckpointStore(tmp_path / "port").save(
        1, controller_state_from_reference(jstate, device="cpu"))
    manifests = [json.loads((tmp_path / d / "step_0000000001" / "manifest.json").read_text())
                 for d in ("jax", "port")]
    keys = [{k: (v["shape"], v["dtype"]) for k, v in m["leaves"].items()} for m in manifests]
    assert keys[0] == keys[1]
    assert {"q", "served_prev", "k", "acc/6", "tick", "fstate/6"} <= set(keys[1])
    assert keys[1]["tick"] == ([], "int32")
    assert jnp.asarray(jstate.tick).dtype == jnp.int32


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """Two gloo ranks (B = 4, no padding): ``plain/`` holds an unsharded
    carry saved after one tick before the ranks start; the ranks save their
    sharded carry after one tick to ``sharded/`` and run the rest from
    ``plain/`` restored onto the sharded loop's template."""
    work = tmp_path_factory.mktemp("layouts")
    r = _ranks.runner(_ranks.scens(4, 19), "dense")
    loop, _ = _ranks.loop_of(r)
    state, _ = loop.run(loop.init(r.k), 1)
    CheckpointStore(work / "plain").save(1, state)
    straight = _ranks.np_out(_ranks.loop_of(r)[0](r.k))
    return work, _ranks.run_ranks(2, ("checkpoint",), work), straight


def test_sharded_carry_restores_onto_the_unsharded_template(layouts):
    """The reference's tests/test_checkpoint.py:178: a carry saved from a
    sharded loop (the first rank writes) resumes on the unsharded loop and
    finishes the run as the straight run does."""
    work, _res, straight = layouts
    r = _ranks.runner(_ranks.scens(4, 19), "dense")
    loop, _ = _ranks.loop_of(r)
    restored, _ = CheckpointStore(work / "sharded").restore(loop.init(r.k), step=1)
    _, out = loop.run(ctl.ControllerState(*restored))
    out = _ranks.np_out(out)
    for key in ("codes", "k", "applied"):
        np.testing.assert_array_equal(out[key], straight[key][1:], err_msg=key)
    for key in ("k_final", "q_final", "offered", "served", "dropped", "q_int", "q_max"):
        np.testing.assert_array_equal(out[key], straight[key], err_msg=key)


def test_unsharded_carry_restores_onto_the_sharded_template(layouts):
    """The reference's tests/test_checkpoint.py:289: an unsharded carry
    restores onto the sharded loop's template on every rank and finishes
    the run as the straight unsharded run does."""
    _work, res, straight = layouts
    for rank, got in res.items():
        out = got["checkpoint"]
        for key in ("codes", "k", "applied"):
            np.testing.assert_array_equal(out[key], straight[key][1:], err_msg=f"{rank} {key}")
        for key in ("k_final", "q_final", "offered", "served", "dropped", "q_int", "q_max"):
            np.testing.assert_array_equal(out[key], straight[key], err_msg=f"{rank} {key}")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def test_cuda_state_saves_and_restores_on_the_card(tmp_path, cuda_device):
    """A card loop's state: ``save_async`` copies it to the host before the
    loop runs on, the restore builds new tensors on the card, and the
    resumed run equals a straight one bit for bit."""
    from repro_torch.api.session import ScenarioRunner
    from repro_torch.convert import scenario_from_reference

    r = ScenarioRunner([scenario_from_reference(s) for s in _scens()], tick_interval=5.0,
                       device=cuda_device)

    def make():
        return ctl.make_fused_loop(r.arrays, r.static, r._params(),
                                   steps_per_tick=r._steps_per_tick, warmup_seconds=5.0,
                                   device=cuda_device)[0]

    ref = {k: v.cpu().numpy() for k, v in make()(r.k).items()
           if isinstance(v, torch.Tensor)}
    loop = make()
    state, _ = loop.run(loop.init(r.k), 2)
    st = CheckpointStore(tmp_path)
    st.save_async(2, state)
    loop.run(state, 1)  # updates the saved state's buffers in place
    st.wait()
    fresh = make()
    restored, _ = st.restore(fresh.init(r.k), step=2)
    restored = ctl.ControllerState(*restored)
    assert restored.tick == 2 and restored.q.device.type == "cuda"
    _, out = fresh.run(restored)
    for key in ("codes", "k", "applied"):
        np.testing.assert_array_equal(out[key].cpu().numpy(), ref[key][2:], err_msg=key)
    for key in ("k_final", "q_final", "offered", "served", "dropped", "q_int", "q_max"):
        np.testing.assert_array_equal(out[key].cpu().numpy(), ref[key], err_msg=key)
