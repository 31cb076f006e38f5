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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..device import resolve_device

__all__ = ["FleetMesh", "bucket_ladder", "fleet_backend", "fleet_mesh", "mesh_axis"]


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
