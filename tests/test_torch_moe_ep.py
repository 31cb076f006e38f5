"""The port's expert-parallel MoE (``models/ffn.py:moe_layer_ep`` on
``torch.distributed``) against the JAX package's ``moe_layer_ep`` on the
CPU.

The port runs on gloo ranks spawned by ``tests/_torch_moe_ep_ranks.py`` at
(data 4, model 1) and (data 2, model 2); the JAX function runs in a
subprocess under ``XLA_FLAGS=--xla_force_host_platform_device_count=8`` on
a mesh of the same shape, built with ``jax.make_mesh(..., axis_types=(Auto,
Auto))``: jax 0.9 makes Explicit axes by default, under which the
reference's ``moe_layer_ep`` raises (its ``with_sharding_constraint`` may
refer only to Auto axes; ``tests/test_moe_ep.py`` fails for this reason).
Both sides take the same seeded numpy inputs: the layer of the reference's
own EP test (8 experts, top-2, a shared expert, d_ff 64, x [8, 16, 32],
float32).  Held: the output within 2e-4 and aux within rtol 1e-4 (the
reference test's limits), every gradient of ``mean(out^2) + 0.01 aux``
(the parameters' and x's) within 2e-4; at capacity 8.0 (no pair dropped)
also against the single-device ``moe_layer`` of both packages; at
capacity 1.25, where the two-stage EP capacities drop other pairs than
``moe_layer``'s, against the JAX EP only.  The mixtral smoke model with
``moe_impl="shard_map_ep"`` on the ranks equals the unsharded model, and
its train step with every layer rematerialised (the backward rerunning
the all-to-alls) has the gradients of the step without the checkpoint,
bit for bit, on every rank.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_moe_ep_ranks import LAYER_CFG, LEAVES, assemble, layer_params, run_ranks
from repro_torch.configs import get_config
from repro_torch.models.ffn import EPGroups, ep_shard, moe_layer, moe_layer_ep
from repro_torch.models.transformer import ep_shard_params, forward, init_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = ((4, 1), (2, 2))
CAPACITIES = (8.0, 1.25)
TOL = 2e-4


def _inputs() -> dict:
    rng = np.random.default_rng(28)
    e, d, f = LAYER_CFG.n_experts, LAYER_CFG.d_model, LAYER_CFG.expert_ff
    z = {"router": rng.normal(0, 0.3, (d, e)), "wi_gate": rng.normal(0, 0.1, (e, d, f)),
         "wi_up": rng.normal(0, 0.1, (e, d, f)), "wo": rng.normal(0, 0.1, (e, f, d)),
         "shared/wi_gate": rng.normal(0, 0.1, (d, f)),
         "shared/wi_up": rng.normal(0, 0.1, (d, f)), "shared/wo": rng.normal(0, 0.1, (f, d)),
         "x": rng.normal(0, 1.0, (8, 16, d))}
    z = {k: v.astype(np.float32) for k, v in z.items()}
    z["tokens"] = rng.integers(0, 256, (4, 12)).astype(np.int32)
    return z


_JAX_MAIN = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8 " + os.environ.get("XLA_FLAGS", "")
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.models.common import ModelConfig, axis_rules
from repro.models.ffn import moe_layer, moe_layer_ep

out_dir = sys.argv[1]
z = dict(np.load(os.path.join(out_dir, "inputs.npz")))
params = {k: jnp.asarray(z[k]) for k in ("router", "wi_gate", "wi_up", "wo")}
params["shared"] = {k: jnp.asarray(z["shared/" + k]) for k in ("wi_gate", "wi_up", "wo")}
x = jnp.asarray(z["x"])
base = ModelConfig(arch="ep-test", family="moe", n_layers=1, d_model=32, n_heads=4,
                   n_kv_heads=2, d_ff=64, vocab=64, n_experts=8, top_k=2, capacity_factor=8.0,
                   n_shared_experts=1, moe_d_ff=64, dtype=jnp.float32)
rules = {"batch": "data", "d_ff": "model", "experts": "data"}

def save(name, fn):
    def loss(p, xx):
        out, aux = fn(p, xx)
        return (out.astype(jnp.float32) ** 2).mean() + 0.01 * aux
    out, aux = jax.jit(fn)(params, x)
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)
    res = {"out": np.asarray(out), "aux": np.asarray(aux), "grad/x": np.asarray(gx)}
    for k, v in gp.items():
        if isinstance(v, dict):
            res.update({f"grad/{k}/{kk}": np.asarray(vv) for kk, vv in v.items()})
        else:
            res[f"grad/{k}"] = np.asarray(v)
    np.savez(os.path.join(out_dir, name + ".npz"), **res)

for cf in (8.0, 1.25):
    cfg = dataclasses.replace(base, capacity_factor=cf)
    if cf == 8.0:
        save(f"moe_layer-{cf}", lambda p, xx: moe_layer(p, xx, cfg))
    for n_ep, n_tp in ((4, 1), (2, 2)):
        mesh = jax.make_mesh((n_ep, n_tp), ("data", "model"), axis_types=(AxisType.Auto,) * 2)

        def ep(p, xx, mesh=mesh, cfg=cfg):
            with axis_rules(rules, mesh):
                return moe_layer_ep(p, xx, cfg)

        with mesh:
            save(f"ep-{n_ep}x{n_tp}-{cf}", ep)
"""


@pytest.fixture(scope="module")
def shared_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_ep")
    np.savez(out / "inputs.npz", **_inputs())
    return out


@pytest.fixture(scope="module")
def jax_results(shared_dir):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_MAIN, str(shared_dir)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    res = {}
    for path in shared_dir.glob("*.npz"):
        if path.stem != "inputs" and not path.stem.startswith("r"):
            with np.load(path) as z:
                res[path.stem] = {k: z[k] for k in z.files}
    return res


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def port_results(request, shared_dir):
    n_ep, n_tp = request.param
    work = shared_dir / f"port-{n_ep}x{n_tp}"
    work.mkdir()
    (work / "inputs.npz").symlink_to(shared_dir / "inputs.npz")
    res = run_ranks(n_ep, n_tp, ["layer-8.0", "layer-1.25", "model", "model-train"], work)
    return n_ep, n_tp, res


def _hold(got: dict, want: dict, what: str) -> None:
    np.testing.assert_allclose(got["out"], want["out"], rtol=TOL, atol=TOL,
                               err_msg=f"{what}: out")
    assert np.ptp(got["aux"]) == 0.0, f"{what}: aux differs between ranks"
    np.testing.assert_allclose(got["aux"][0], want["aux"], rtol=1e-4, err_msg=f"{what}: aux")
    for key in ("grad/x", *(f"grad/{k}" for k in LEAVES)):
        w = want[key]
        assert np.abs(w).max() > 0, key
        np.testing.assert_allclose(got[key], w, rtol=TOL, atol=TOL * np.abs(w).max(),
                                   err_msg=f"{what}: {key}")


@pytest.mark.parametrize("cf", CAPACITIES)
def test_ep_ranks_match_the_jax_ep_on_an_auto_axis_mesh(port_results, jax_results, cf):
    n_ep, n_tp, res = port_results
    got = assemble(res, f"layer-{cf}", n_ep, n_tp)
    _hold(got, jax_results[f"ep-{n_ep}x{n_tp}-{cf}"], f"{n_ep}x{n_tp} cf {cf}")


def test_ep_ranks_without_drops_match_moe_layer(port_results, jax_results):
    """Capacity 8.0: no pair drops on either path, so the EP layer is the
    single-device layer -- the JAX ``moe_layer``'s output, aux and
    gradients, and the port's ``moe_layer``'s."""
    n_ep, n_tp, res = port_results
    got = assemble(res, "layer-8.0", n_ep, n_tp)
    _hold(got, jax_results["moe_layer-8.0"], f"{n_ep}x{n_tp} vs JAX moe_layer")
    z = _inputs()
    out, aux = moe_layer(layer_params(z), torch.from_numpy(z["x"]), LAYER_CFG)
    np.testing.assert_allclose(got["out"], out.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["aux"][0], float(aux), rtol=1e-4)


def test_drops_at_capacity_1_25_differ_from_moe_layer(jax_results):
    """At capacity 1.25 the two-stage EP capacities keep other pairs than
    ``moe_layer``'s one capacity, so EP and the single-device layer differ
    (the reason that case is held against the JAX EP only)."""
    z = _inputs()
    cfg = dataclasses.replace(LAYER_CFG, capacity_factor=1.25)
    out, _ = moe_layer(layer_params(z), torch.from_numpy(z["x"]), cfg)
    assert np.abs(out.numpy() - jax_results["ep-4x1-1.25"]["out"]).max() > 1e-2


def test_model_with_ep_matches_the_unsharded_model(port_results):
    """mixtral smoke, float32, ``moe_impl="shard_map_ep"``, on the ranks
    (each with its batch shard and expert shard) against the same model
    unsharded: logits within 1e-5, aux within rtol 1e-6 (the smoke config's
    capacity 8.0 drops nothing)."""
    n_ep, n_tp, res = port_results
    got = assemble(res, "model", n_ep, n_tp)
    cfg = dataclasses.replace(get_config("mixtral-8x22b", "smoke"), dtype=torch.float32)
    z = _inputs()
    logits, aux = forward(init_params(cfg, seed=0, device="cpu"), cfg,
                          {"tokens": torch.from_numpy(z["tokens"])})
    np.testing.assert_allclose(got["logits"], logits.detach().numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["aux"], float(aux), rtol=1e-6)


def test_ep_train_step_with_remat_equals_the_direct_step_on_every_rank(port_results):
    """One train step of the mixtral smoke model with ``moe_impl="shard_map_ep"``
    on the ranks: each of its two layers runs under the non-reentrant
    checkpoint, so the backward reruns ``moe_layer_ep``'s all-to-alls and
    all-reduces; every rank's loss and every gradient of its shard bitwise
    those of the same step with the checkpoint replaced by a direct call."""
    _n_ep, _n_tp, res = port_results
    for rank, cases in res.items():
        r = cases["model-train"]
        assert int(r["bodies"]) == 2, rank
        assert np.isfinite(r["loss"]) and np.array_equal(r["loss"], r["loss_direct"]), rank
        keys = [k for k in r if k.startswith("remat/")]
        assert keys and any(np.abs(r[k]).max() > 0 for k in keys if "moe_wo" in k)
        for key in keys:
            assert np.array_equal(r[key], r["direct/" + key[len("remat/"):]]), (rank, key)


def test_ep_without_groups_is_moe_layer():
    """No groups: ``moe_layer_ep`` is ``moe_layer`` on full parameters (the
    reference's fallback without a mesh)."""
    z = _inputs()
    x = torch.from_numpy(z["x"])
    a = moe_layer(layer_params(z), x, LAYER_CFG)
    for groups in (None, EPGroups(None)):
        b = moe_layer_ep(layer_params(z), x, LAYER_CFG, groups)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_ep_shard_cuts_experts_and_d_ff():
    z = _inputs()
    params = layer_params(z)
    shard = ep_shard(params, LAYER_CFG, 1, 2, 1, 2)
    assert torch.equal(shard["wi_gate"], params["wi_gate"][4:, :, 32:])
    assert torch.equal(shard["wo"], params["wo"][4:, 32:])
    assert torch.equal(shard["shared"]["wo"], params["shared"]["wo"][32:])
    assert shard["router"] is params["router"]
    with pytest.raises(ValueError, match="experts"):
        ep_shard(params, LAYER_CFG, 0, 3)
    cfg = dataclasses.replace(get_config("kimi-k2-1t-a32b", "smoke"), dtype=torch.float32)
    full = init_params(cfg, seed=0, device="cpu")
    cut = ep_shard_params(full, cfg, 1, 2)
    assert cut["layers"]["moe_wi_up"].shape == (2, 4, 64, 32)
    assert torch.equal(cut["layers"]["moe_wi_up"], full["layers"]["moe_wi_up"][:, 4:])
