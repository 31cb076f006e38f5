"""Distribution layer of the port: the part of ``repro/distributed/`` it
runs -- the fleet mesh over ``torch.distributed`` (``sharding``) and int8
gradient compression (``compress``)."""

from . import compress
from .sharding import FleetMesh, bucket_ladder, fleet_backend, fleet_mesh, mesh_axis

__all__ = ["FleetMesh", "bucket_ladder", "compress", "fleet_backend", "fleet_mesh",
           "mesh_axis"]
