"""Ranks of an expert-parallel MoE mesh on the CPU, for
``tests/test_torch_moe_ep.py``.

:func:`run_ranks` spawns ``n_ep x n_tp`` processes (``torch.multiprocessing``,
the spawn method) joined into one gloo process group through a ``file://``
store in the test's own directory, builds the ``(n_ep, n_tp)`` mesh with
``models.ffn.ep_groups`` (rank = data index x ``n_tp`` + model index, the
order of ``jax.make_mesh((n_ep, n_tp), ("data", "model"))``) and runs each
named case of :data:`CASES` on every rank on the inputs the test saved as
``inputs.npz``.  Each rank saves its results as ``r<rank>-<case>.npz``;
:func:`run_ranks` returns them as ``{rank: {case: dict}}``.  A rank that
raises fails the run, and a run past its deadline is killed and fails.

This module imports neither JAX nor the JAX package: the spawned ranks
import it, and the port alone.
"""

from __future__ import annotations

import dataclasses
import pathlib
import time

import numpy as np
import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.ffn import ep_groups, ep_shard, moe_layer_ep

#: The MoE layer of the reference's own EP test (``tests/_ep_equiv_main.py``):
#: 8 experts, top-2, one shared expert, d_ff 64, float32.
LAYER_CFG = ModelConfig(arch="ep-test", family="moe", n_layers=1, d_model=32, n_heads=4,
                        n_kv_heads=2, d_ff=64, vocab=64, n_experts=8, top_k=2,
                        capacity_factor=8.0, n_shared_experts=1, moe_d_ff=64,
                        dtype=torch.float32)
#: The layer's parameter leaves, in the saved order.
LEAVES = ("router", "wi_gate", "wi_up", "wo", "shared/wi_gate", "shared/wi_up", "shared/wo")
#: Each leaf's (experts axis, d_ff axis); None where it is not cut.
CUTS = {"router": (None, None), "wi_gate": (0, 2), "wi_up": (0, 2), "wo": (0, 1),
        "shared/wi_gate": (None, 1), "shared/wi_up": (None, 1), "shared/wo": (None, 0)}


def layer_params(z) -> dict:
    """The layer's parameters as tensors from the saved inputs."""
    p = {k: torch.from_numpy(z[k]) for k in LEAVES if "/" not in k}
    p["shared"] = {k.split("/")[1]: torch.from_numpy(z[k]) for k in LEAVES if "/" in k}
    return p


def _flat(tree: dict) -> dict:
    """{"router": .., "shared/wi_gate": ..}: one level of nesting as paths."""
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{key}/{k}": w for k, w in v.items()})
        else:
            out[key] = v
    return out


def _layer_case(z, cf: float, groups, di: int, n_ep: int, tj: int, n_tp: int) -> dict:
    """``moe_layer_ep`` on the rank's batch shard and parameter slice: its
    output and aux, and the gradients of the global loss ``mean(out^2) +
    0.01 aux`` -- the rank's own slices for the cut leaves, summed over the
    ranks that share a leaf for the rest (the router over all, the shared
    expert over the EP group, x over the model group)."""
    import torch.distributed as dist

    cfg = dataclasses.replace(LAYER_CFG, capacity_factor=cf)
    shard = ep_shard(layer_params(z), cfg, di, n_ep, tj, n_tp)
    x_all = torch.from_numpy(z["x"])
    b_loc = x_all.shape[0] // n_ep
    leaves = {k: v.detach().clone().requires_grad_() for k, v in _flat(shard).items()}
    x = x_all[di * b_loc:(di + 1) * b_loc].clone().requires_grad_()
    tree = {k: v for k, v in leaves.items() if "/" not in k}
    tree["shared"] = {k.split("/")[1]: v for k, v in leaves.items() if "/" in k}
    out, aux = moe_layer_ep(tree, x, cfg, groups)
    loss = ((out ** 2).sum() / x_all[..., 0].numel() / out.shape[-1]
            + 0.01 * aux / n_ep) / n_tp
    grads = torch.autograd.grad(loss, [*leaves.values(), x])
    res = {"out": out.detach().numpy(), "aux": aux.detach().numpy()}
    for (name, _v), g in zip(leaves.items(), grads):
        g = g.contiguous()
        if name == "router":
            dist.all_reduce(g)
        elif name.startswith("shared/"):
            dist.all_reduce(g, group=groups.ep)
        res[f"grad/{name}"] = g.numpy()
    gx = grads[-1].contiguous()
    if groups.tp is not None:
        dist.all_reduce(gx, group=groups.tp)
    res["grad/x"] = gx.numpy()
    return res


def _model_case(z, groups, di: int, n_ep: int, tj: int, n_tp: int) -> dict:
    """The mixtral smoke model (float32, ``moe_impl="shard_map_ep"``, seed 0)
    on the rank's batch shard with its expert shard: the logits and aux."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import ep_shard_params, forward, init_params

    cfg = dataclasses.replace(get_config("mixtral-8x22b", "smoke"), dtype=torch.float32,
                              moe_impl="shard_map_ep")
    params = ep_shard_params(init_params(cfg, seed=0, device="cpu"), cfg, di, n_ep, tj, n_tp)
    tokens = torch.from_numpy(z["tokens"])
    b_loc = tokens.shape[0] // n_ep
    with torch.no_grad():
        logits, aux = forward(params, cfg, {"tokens": tokens[di * b_loc:(di + 1) * b_loc]},
                              ep=groups)
    return {"logits": logits.numpy(), "aux": aux.numpy()}


def _model_train_case(z, groups, di: int, n_ep: int, tj: int, n_tp: int) -> dict:
    """One train step's gradients of the mixtral smoke model (as
    :func:`_model_case`) on the rank's batch shard with its expert shard:
    ``loss_fn`` with every layer rematerialised (the collectives of
    ``moe_layer_ep`` rerun in the backward, on every rank in the same
    order), then with the checkpoint replaced by a direct call; and how many
    bodies the first run checkpointed."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tr
    from repro_torch.tree import flatten_with_paths, unflatten

    cfg = dataclasses.replace(get_config("mixtral-8x22b", "smoke"), dtype=torch.float32,
                              moe_impl="shard_map_ep")
    params = tr.ep_shard_params(tr.init_params(cfg, seed=0, device="cpu"), cfg, di, n_ep, tj,
                                n_tp)
    tokens = torch.from_numpy(z["tokens"]).long()
    b_loc = tokens.shape[0] // n_ep
    rows = slice(di * b_loc, (di + 1) * b_loc)
    batch = {"tokens": tokens[rows], "labels": torch.roll(tokens, -1, dims=1)[rows]}
    paths = flatten_with_paths(params)

    def gradients():
        leaves = [p.detach().requires_grad_() for _k, p in paths]
        tree = unflatten(params, {k: t for (k, _p), t in zip(paths, leaves)})
        total, _ = tr.loss_fn(tree, cfg, batch, ep=groups)
        return total.detach(), torch.autograd.grad(total, leaves)

    real, bodies = tr.checkpoint, []

    def counting(fn, *args, **kw):
        bodies.append(fn.__name__)
        return real(fn, *args, **kw)

    try:
        tr.checkpoint = counting
        loss, grads = gradients()
        tr.checkpoint = lambda fn, *args, **_kw: fn(*args)
        loss_d, grads_d = gradients()
    finally:
        tr.checkpoint = real
    res = {"loss": loss.numpy(), "loss_direct": loss_d.numpy(),
           "bodies": np.array(len(bodies))}
    for (key, _p), g, g_d in zip(paths, grads, grads_d):
        res[f"remat/{key}"] = g.numpy()
        res[f"direct/{key}"] = g_d.numpy()
    return res


CASES = {
    "layer-8.0": lambda z, *a: _layer_case(z, 8.0, *a),
    "layer-1.25": lambda z, *a: _layer_case(z, 1.25, *a),
    "model": _model_case,
    "model-train": _model_train_case,
}


def _rank_main(rank: int, world: int, n_ep: int, n_tp: int, out_dir: str, cases) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    out = pathlib.Path(out_dir)
    dist.init_process_group("gloo", init_method=f"file://{out / 'store'}", rank=rank,
                            world_size=world)
    try:
        groups, di, tj = ep_groups(n_ep, n_tp)
        with np.load(out / "inputs.npz") as z:
            z = {k: z[k] for k in z.files}
        for name in cases:
            res = CASES[name](z, groups, di, n_ep, tj, n_tp)
            np.savez(out / f"r{rank}-{name}.npz", **res)
    finally:
        dist.destroy_process_group()


def run_ranks(n_ep: int, n_tp: int, cases, out_dir: pathlib.Path, timeout: float = 240.0
              ) -> dict:
    """Run ``cases`` on ``n_ep x n_tp`` gloo ranks; ``{rank: {case: results}}``
    (``out_dir`` must hold ``inputs.npz``)."""
    import torch.multiprocessing as mp

    world = n_ep * n_tp
    ctx = mp.spawn(_rank_main, args=(world, n_ep, n_tp, str(out_dir), tuple(cases)),
                   nprocs=world, join=False)
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} EP ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    res = {}
    for rank in range(world):
        res[rank] = {}
        for name in cases:
            with np.load(pathlib.Path(out_dir) / f"r{rank}-{name}.npz") as z:
                res[rank][name] = {k: z[k] for k in z.files}
    return res


def assemble(res: dict, case: str, n_ep: int, n_tp: int) -> dict:
    """One case's results over the mesh as whole arrays: ``out`` (and
    ``logits``) and ``grad/x`` concatenated over the data index, the cut
    leaves' gradients from their slices, the rest (reduced) from rank 0,
    and ``aux`` from every rank (it must be one value)."""
    whole = {}
    data = [res[i * n_tp][case] for i in range(n_ep)]
    for key in ("out", "logits", "grad/x"):
        if key in data[0]:
            whole[key] = np.concatenate([d[key] for d in data])
    whole["aux"] = np.array([res[r][case]["aux"] for r in res])
    for name, (e_axis, f_axis) in CUTS.items():
        key = f"grad/{name}"
        if key not in data[0]:
            continue
        if e_axis is None and f_axis is None:
            whole[key] = res[0][case][key]
            continue
        rows = []
        for i in range(n_ep if e_axis is not None else 1):
            cols = [res[i * n_tp + j][case][key] for j in range(n_tp)]
            rows.append(np.concatenate(cols, axis=f_axis))
        whole[key] = rows[0] if e_axis is None else np.concatenate(rows, axis=e_axis)
    return whole
