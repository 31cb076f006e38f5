"""Batch-axis layout of the control plane: the port's copy of the part of
``repro/distributed/sharding.py`` it runs.

* :func:`fleet_mesh` is the 1-D fleet mesh over a ``torch.distributed``
  process group (the JAX package's ``Mesh(devices, ("fleet",))``).  The
  control plane is data-parallel over the scenario / tenant axis B, so its
  mesh is one axis.  Every rank calls the same entry points with the same
  arguments (SPMD, as under ``shard_map``); each computes its own lane
  shard and keeps it; the collectives here (``all_gather`` and
  ``barrier`` on the group) assemble the whole fleet's outputs on every
  rank when a caller reports or saves.  The caller initialises the
  process group; its backend is the group's own (:func:`fleet_backend`
  gives the rule).
* :func:`bucket_ladder` is the sparse decide's static ladder of compacted
  widths (per shard under a mesh).
* The model families' rule tables (``TRAIN_RULES``, ``PREFILL_RULES``,
  ``DECODE_RULES``, ``ARCH_RULE_OVERRIDES``) map logical axes to the
  axes of a ``("pod", "data", "model")`` mesh: batch over (pod, data);
  tensor parallelism over heads / d_ff / vocab on "model"; FSDP of the
  parameters' d_model over "data" in training; experts over "data" where
  they divide; the decode cache's sequence over "model".
  :func:`safe_spec` drops an assignment whose dim the mesh axes do not
  divide (whisper's vocabulary of 51,865 stays whole) and a mesh axis an
  earlier dim took; :func:`tree_specs`, :func:`batch_spec` and
  :func:`cache_specs` give every leaf's spec and :func:`shard_bytes` a
  device's bytes of it.  A spec is a tuple of entries (``None``, an axis
  name or a tuple of names), as the reference's ``PartitionSpec`` holds
  them; the meshes are shapes only (``launch/mesh.py:LogicalMesh``).  The
  dry-run (``launch/dryrun.py``) is their user: the port's model runs
  unsharded on one card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from ..device import resolve_device

__all__ = ["FleetMesh", "bucket_ladder", "fleet_backend", "fleet_mesh", "mesh_axis",
           "TRAIN_RULES", "PREFILL_RULES", "DECODE_RULES", "ARCH_RULE_OVERRIDES", "rules_for",
           "prune_rules", "spec_axes", "safe_spec", "tree_specs", "batch_spec", "cache_axes",
           "cache_specs", "shard_bytes"]


@dataclass(frozen=True)
class FleetMesh:
    """A 1-D mesh over the fleet's batch axis: ``size`` ranks of a process
    ``group`` (``None`` for the one-rank mesh, which needs no collectives),
    this process's ``rank`` in it, the axis name and the ``device`` this
    rank computes on.

    The collectives take and return tensors on ``device``.  Bool tensors
    travel as ``uint8``.  gloo stages CUDA tensors through host memory,
    so several ranks can share one card; NCCL needs a card per rank."""

    group: Any
    size: int
    rank: int
    device: torch.device
    axis_names: tuple = ("fleet",)
    backend: str | None = None

    def shard(self, b_pad: int) -> slice:
        """This rank's lanes of a batch extent ``b_pad`` (a multiple of
        ``size``): the ``rank``-th of ``size`` equal contiguous blocks."""
        if b_pad % self.size:
            raise ValueError(f"batch extent {b_pad} is not a multiple of {self.size} ranks")
        w = b_pad // self.size
        return slice(self.rank * w, (self.rank + 1) * w)

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` (the same shape on each) concatenated along
        ``dim`` in rank order."""
        if self.group is None:
            return x
        import torch.distributed as dist

        is_bool = x.dtype == torch.bool
        src = (x.to(torch.uint8) if is_bool else x).contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat(parts, dim=dim)
        return out.to(torch.bool) if is_bool else out

    def barrier(self) -> None:
        if self.group is not None:
            import torch.distributed as dist

            if self.backend == "nccl":
                dist.barrier(group=self.group, device_ids=[self.device.index or 0])
            else:
                dist.barrier(group=self.group)


def fleet_backend(device, world_size: int) -> str:
    """The process-group backend of a fleet mesh of ``world_size`` ranks on
    ``device``: NCCL when each rank has a card of its own, else gloo (the
    CPU, and several ranks sharing one card, which NCCL refuses)."""
    dev = torch.device(device)
    if dev.type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def fleet_mesh(n_devices: int | None = None, *, group=None, axis: str = "fleet",
               device=None) -> FleetMesh:
    """The 1-D fleet mesh (``repro/distributed/sharding.py:fleet_mesh``).

    With an initialised process group, the mesh spans ``group`` (default:
    the whole world) and ``n_devices``, if given, must equal its size;
    without one, only the one-rank mesh exists.  ``fleet_mesh(1)`` is the
    one-rank baseline on every rank: no group, no collectives.
    ``device`` defaults to the rank's card under NCCL (the current CUDA
    device) and to the CUDA device otherwise (raising when there is none:
    pass ``device="cpu"`` for gloo ranks on the CPU)."""
    import torch.distributed as dist

    if n_devices is not None and n_devices < 1:
        raise ValueError(f"a fleet mesh needs >= 1 rank, got {n_devices}")
    if n_devices == 1 or not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"requested {n_devices} ranks but no process group is initialised "
                "(torch.distributed.init_process_group)")
        return FleetMesh(group=None, size=1, rank=0, device=resolve_device(device),
                         axis_names=(axis,))
    group = dist.group.WORLD if group is None else group
    size = dist.get_world_size(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"requested {n_devices} ranks, the process group has {size}")
    backend = dist.get_backend(group)
    if device is None and backend == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = resolve_device(device)
    return FleetMesh(group=group, size=size, rank=dist.get_rank(group), device=dev,
                     axis_names=(axis,), backend=backend)


def mesh_axis(mesh, what: str) -> tuple[str, int]:
    """The (axis name, rank count) of a 1-D :class:`FleetMesh`; ``what``
    names the caller in the error ("controller mesh must be 1-D ...")."""
    names = getattr(mesh, "axis_names", None)
    if names is not None and len(names) != 1:
        hint = " (batch axis only)" if what == "controller" else ""
        raise ValueError(f"{what} mesh must be 1-D{hint}; got axes {tuple(names)}")
    if not isinstance(mesh, FleetMesh):
        raise ValueError(
            f"{what} mesh must be a repro_torch FleetMesh (fleet_mesh()), got "
            f"{type(mesh).__name__}")
    return names[0], int(mesh.size)


def bucket_ladder(b: int, *, fractions: tuple[int, ...] = (16, 4, 1)) -> tuple[int, ...]:
    """Ascending compacted widths for a batch extent ``b``: ``ceil(b / f)``
    for each fraction ``f``, and ``b`` itself (the dense rung, always
    present, so a tick on which every lane is repriced runs the dense
    decide).  The sparse decide gathers the repriced lanes into the
    smallest rung that holds them, so each tick runs at one of a few
    widths instead of at its exact active count.  Under a mesh ``b`` is
    the shard's extent: each rank compacts its own lanes, with no
    collective, and a rank whose lanes are all hot runs its dense rung
    while a quiet one runs a small rung."""
    if b < 1:
        raise ValueError(f"batch extent must be >= 1, got {b}")
    widths = {max(1, -(-b // f)) for f in fractions}
    widths.add(b)
    return tuple(sorted(w for w in widths if w <= b))


# --------------------------------------------------------------------------- #
# Rule-based layouts of the model families (the dry-run's per-device shards)
# --------------------------------------------------------------------------- #
TRAIN_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq_sp": "model",  # sequence-parallel residual stream between blocks
    "heads": "model",
    "kv_heads": "model",
    "d_ff": "model",
    "vocab": "model",
    "experts": "data",  # expert parallelism where the count divides; else FSDP
    "d_model": "data",  # FSDP axis of the parameters (activations: batch takes "data")
    "layers": None,
    "kv_seq": None,
    "enc_seq": None,
}

PREFILL_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq_sp": None,
    "heads": "model",
    "kv_heads": "model",
    "d_ff": "model",
    "vocab": "model",
    "experts": "data",
    "d_model": None,  # no FSDP at serve time: weights replicated over data
    "layers": None,
    "kv_seq": None,
    "enc_seq": None,
}

DECODE_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq_sp": None,
    "heads": "model",
    "kv_heads": "model",
    "d_ff": "model",
    "vocab": "model",
    "experts": "data",
    "d_model": None,
    "layers": None,
    "kv_seq": "model",  # sequence-sharded KV cache (flash-decoding)
    "enc_seq": None,
}

#: Per-arch corrections, merged between the base table and the caller's
#: overrides.  mixtral-8x22b's 8 experts do not divide a 16-wide data axis,
#: so its experts are FSDP'd over d_model at serve time.
ARCH_RULE_OVERRIDES: dict[tuple[str, str], dict[str, Any]] = {
    ("mixtral-8x22b", "prefill"): {"d_model": "data"},
    ("mixtral-8x22b", "decode"): {"d_model": "data"},
}


def rules_for(mode: str, overrides: dict[str, Any] | None = None, *,
              arch: str | None = None) -> dict[str, Any]:
    """The rule table of ``mode`` (train, prefill or decode), with the
    arch's corrections and then ``overrides`` merged in."""
    base = {"train": TRAIN_RULES, "prefill": PREFILL_RULES, "decode": DECODE_RULES}[mode]
    out = dict(base)
    if arch is not None:
        out.update(ARCH_RULE_OVERRIDES.get((arch, mode), {}))
    if overrides:
        out.update(overrides)
    return out


def prune_rules(rules: dict[str, Any], mesh) -> dict[str, Any]:
    """Drop mesh axes the mesh lacks (e.g. "pod" on one pod)."""
    names = set(mesh.axis_names)
    out: dict[str, Any] = {}
    for k, v in rules.items():
        if v is None:
            out[k] = None
            continue
        kept = tuple(p for p in ((v,) if isinstance(v, str) else tuple(v)) if p in names)
        out[k] = None if not kept else (kept[0] if len(kept) == 1 else kept)
    return out


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry (``None``, a name or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def safe_spec(shape: tuple[int, ...], axes: tuple, rules: dict[str, Any], mesh) -> tuple:
    """The spec of a tensor of ``shape`` with logical ``axes``: each dim
    takes the longest prefix of its rule's mesh axes whose product divides
    it (the divisibility guard), leaving out axes an earlier dim took (the
    axis-reuse guard); a dim with none is replicated (``None``).  Reads
    only ``mesh.shape`` and ``mesh.axis_names``."""
    used: set[str] = set()
    spec: list[Any] = []
    for dim, ax in zip(shape, axes):
        m = rules.get(ax) if ax is not None else None
        if m is None:
            spec.append(None)
            continue
        parts = [p for p in spec_axes(m) if p not in used]
        chosen: list[str] = []
        n = 1
        for p in parts:
            if dim % (n * mesh.shape[p]) == 0:
                chosen.append(p)
                n *= mesh.shape[p]
        if not chosen:
            spec.append(None)
            continue
        used.update(chosen)
        spec.append(chosen[0] if len(chosen) == 1 else tuple(chosen))
    return tuple(spec)


def _is_axes(t) -> bool:
    return isinstance(t, tuple) and all(isinstance(e, (str, type(None))) for e in t)


def tree_specs(shapes_tree: Any, axes_tree: Any, mesh, rules: dict[str, Any]) -> Any:
    """The spec of every leaf of a params-like tree (nested dicts, lists or
    tuples of tensors or shapes; the reference's ``tree_shardings``)
    against its matching tree of logical-axis tuples."""
    if _is_axes(axes_tree):
        shape = getattr(shapes_tree, "shape", shapes_tree)
        return safe_spec(tuple(shape), axes_tree, rules, mesh)
    if isinstance(axes_tree, dict):
        return {k: tree_specs(shapes_tree[k], a, mesh, rules) for k, a in axes_tree.items()}
    return type(axes_tree)(tree_specs(s, a, mesh, rules) for s, a in zip(shapes_tree, axes_tree))


_BATCH_AXES: dict[str, tuple] = {
    "tokens": ("batch", None),
    "labels": ("batch", None),
    "mask": ("batch", None),
    "patch_embeds": ("batch", None, None),
    "positions_3d": (None, "batch", None),
    "frames": ("batch", "enc_seq", None),
}


def batch_spec(name: str, shape: tuple[int, ...], rules: dict[str, Any], mesh) -> tuple:
    """The spec of a named model input (a decode step's ``tokens`` [B] on
    the batch axes; an unknown input replicated)."""
    if name == "tokens" and len(shape) == 1:
        return safe_spec(shape, ("batch",), rules, mesh)
    axes = _BATCH_AXES.get(name)
    if axes is None or len(axes) != len(shape):
        return ()
    return safe_spec(shape, axes, rules, mesh)


def cache_axes(family: str) -> dict[str, tuple]:
    """The logical axes of each leaf of ``models.serve.init_cache``'s
    cache for ``family``."""
    kv = ("layers", "batch", "kv_seq", "kv_heads", None)
    if family in ("dense", "moe", "vlm"):
        return {"k": kv, "v": kv, "length": ()}
    if family == "ssm":
        return {"wkv": ("layers", "batch", "heads", None, None),
                "tm_shift": ("layers", "batch", "d_model"),
                "cm_shift": ("layers", "batch", "d_model"), "length": ()}
    if family == "hybrid":
        return {"ssm": ("layers", "batch", "heads", None, None), "k": kv, "v": kv,
                "length": ()}
    if family == "audio":
        cross = ("layers", "batch", "enc_seq", "kv_heads", None)
        return {"k": kv, "v": kv, "xk": cross, "xv": cross, "length": ()}
    raise ValueError(family)


def cache_specs(cache_shapes: dict, family: str, mesh, rules: dict) -> dict:
    """The spec of every cache leaf (the reference's ``cache_shardings``)."""
    ax = cache_axes(family)
    return {k: safe_spec(tuple(v.shape), ax[k], rules, mesh) for k, v in cache_shapes.items()}


def shard_bytes(shape, dtype, spec: tuple, mesh) -> int:
    """Bytes of one device's shard of a ``shape`` tensor of ``dtype`` laid
    out by ``spec`` (every sharded dim divides evenly: :func:`safe_spec`
    guarantees it)."""
    n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    for entry in spec:
        for p in spec_axes(entry):
            n //= mesh.shape[p]
    return n
