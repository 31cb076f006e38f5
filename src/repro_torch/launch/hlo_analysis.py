"""Roofline terms of a dry-run cell (the port of
``repro/launch/hlo_analysis.py``), with the reference's field names.

All quantities are per device; the terms are

    compute    = flops / PEAK_FLOPS_BF16    (s)
    memory     = bytes_accessed / HBM_BW    (s)
    collective = collective_bytes / link    (s)

on :class:`~repro_torch.launch.mesh.HW`, the H100's rates, the collective
term at the slowest link the mesh crosses (``HW.link``).  The
reference's ``collective_bytes(hlo_text)`` parses collectives out of
XLA's optimized HLO; the port has no HLO, and its collectives come from
the trace's own model (``launch/trace_cost.py``), so it has no
counterpart.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field

from .mesh import HW

__all__ = ["CollectiveStats", "RooflineTerms", "roofline_terms", "model_flops_for"]


@dataclass
class CollectiveStats:
    bytes_by_kind: dict = field(default_factory=dict)
    count_by_kind: dict = field(default_factory=dict)

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())


@dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float  # 6 N D (train) or 2 N D, N the active parameters; global
    useful_ratio: float  # model_flops / global traced flops
    memory_analysis: dict = field(default_factory=dict)
    collectives: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return asdict(self)


def roofline_terms(*, arch: str, shape: str, mesh_name: str, chips: int, cost: dict,
                   coll: CollectiveStats, model_flops: float,
                   memory_analysis: dict | None = None,
                   link_bw: float = HW.NET_BW) -> RooflineTerms:
    """The three terms of ``cost`` (``{"flops", "bytes accessed"}`` per
    device) and ``coll``, the dominant one and the useful share."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    cb = float(coll.total_bytes)
    terms = {"compute": flops / HW.PEAK_FLOPS_BF16, "memory": byts / HW.HBM_BW,
             "collective": cb / link_bw}
    dominant = max(terms, key=terms.get)
    global_flops = flops * chips
    return RooflineTerms(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips, flops_per_device=flops,
        bytes_per_device=byts, collective_bytes_per_device=cb, compute_s=terms["compute"],
        memory_s=terms["memory"], collective_s=terms["collective"], dominant=dominant,
        model_flops=model_flops,
        useful_ratio=(model_flops / global_flops) if global_flops > 0 else 0.0,
        memory_analysis=memory_analysis or {},
        collectives={"bytes_by_kind": coll.bytes_by_kind, "count_by_kind": coll.count_by_kind})


def model_flops_for(cfg, shape_spec) -> float:
    """MODEL_FLOPS: 6 N D for training, 2 N D for a forward-only unit; N
    the active parameters (MoE-aware), D the tokens of the unit (train and
    prefill: batch x seq; decode: batch x 1)."""
    n_active = cfg.active_params_count()
    if shape_spec.kind == "train":
        return 6.0 * n_active * shape_spec.global_batch * shape_spec.seq_len
    if shape_spec.kind == "prefill":
        return 2.0 * n_active * shape_spec.global_batch * shape_spec.seq_len
    return 2.0 * n_active * shape_spec.global_batch
