"""Checkpoints of the fused loop's state (and any tree of tensors), in the
JAX store's on-disk format."""

from .store import CheckpointStore

__all__ = ["CheckpointStore"]
