"""Batch-axis layout of the control plane (the port's copy of the part of
``repro/distributed/`` it runs: the sparse decide's bucket ladder)."""

from .sharding import bucket_ladder

__all__ = ["bucket_ladder"]
