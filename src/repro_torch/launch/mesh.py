"""Meshes and the card's constants for the dry-run (the port of
``repro/launch/mesh.py``).

A :class:`LogicalMesh` is the shape of a device mesh -- axis names mapped
to sizes -- with no devices behind it: the dry-run costs a cell for a
mesh of any size on the host, and :mod:`repro_torch.distributed.sharding`
reads only ``.shape`` and ``.axis_names``.  :class:`HW` holds one NVIDIA
H100 SXM 80GB's rates for the roofline.
"""

from __future__ import annotations

__all__ = ["LogicalMesh", "make_production_mesh", "make_local_mesh", "mesh_name", "HW"]


class LogicalMesh:
    """Axis names mapped to sizes, in order: ``.shape`` (a dict),
    ``.axis_names``, ``.size`` (the device count)."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} differ in length")
        self.shape = dict(zip(axis_names, (int(n) for n in shape)))
        self.axis_names = tuple(axis_names)
        self.size = 1
        for n in self.shape.values():
            self.size *= n

    def __repr__(self) -> str:
        return f"LogicalMesh({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    """16 x 16 = 256 devices as ("data", "model"); 2 x 16 x 16 = 512 with a
    leading "pod" axis."""
    if multi_pod:
        return LogicalMesh((2, 16, 16), ("pod", "data", "model"))
    return LogicalMesh((16, 16), ("data", "model"))


def mesh_name(multi_pod: bool) -> str:
    """The records' mesh names: ``pod16x16`` and ``pod2x16x16``."""
    return "pod2x16x16" if multi_pod else "pod16x16"


def make_local_mesh() -> LogicalMesh:
    """(1, n, 1) as ("pod", "data", "model") over the visible CUDA devices
    (n = 1 on the CPU)."""
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return LogicalMesh((1, max(n, 1), 1), ("pod", "data", "model"))


class HW:
    """One NVIDIA H100 SXM 80GB, per device (NVIDIA's H100 data sheet, SXM
    part, dense rates without sparsity, at the full 700 W power limit)."""

    NAME = "NVIDIA H100 SXM 80GB"
    PEAK_FLOPS_BF16 = 989e12  # FLOP/s, bf16 tensor cores, dense
    HBM_BW = 3.35e12  # B/s, HBM3
    HBM_BYTES = 80e9  # 80 GB of HBM3
    #: NVLink 4 within one 8-GPU HGX node: 900 GB/s per GPU over both
    #: directions, 450e9 B/s each way.
    NVLINK_BW = 450e9
    #: Between nodes: one 400 Gb/s NDR InfiniBand adapter per GPU (the HGX
    #: H100 reference design), 50e9 B/s.
    NET_BW = 50e9
    NODE_DEVICES = 8

    @classmethod
    def link(cls, mesh) -> tuple[str, float]:
        """(name, B/s) of the collective term's link: the slowest the
        mesh's collectives cross.  A mesh of at most one node's 8 devices
        stays on NVLink; a larger one has an axis that crosses nodes (a
        16-wide axis spans two nodes), so its collectives run at the
        network's rate."""
        if mesh.size <= cls.NODE_DEVICES:
            return "NVLink", cls.NVLINK_BW
        return "NDR InfiniBand", cls.NET_BW
