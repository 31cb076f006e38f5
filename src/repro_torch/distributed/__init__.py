"""Batch-axis layout of the control plane (the port's copy of the part of
``repro/distributed/`` it runs: the fleet mesh over ``torch.distributed``
and the sparse decide's bucket ladder)."""

from .sharding import FleetMesh, bucket_ladder, fleet_backend, fleet_mesh, mesh_axis

__all__ = ["FleetMesh", "bucket_ladder", "fleet_backend", "fleet_mesh", "mesh_axis"]
