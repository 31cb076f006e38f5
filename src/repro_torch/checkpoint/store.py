"""Atomic, async checkpoints of a tree of tensors -- the counterpart of
``repro/checkpoint/store.py``, in the same on-disk format.

* **Layout**: one ``.npy`` file per leaf plus a JSON manifest keyed by the
  leaf's path: NamedTuple fields and dict keys by name, tuple and list items
  by index, joined by ``/`` (``q``, ``acc/0``, ``tick``, ``fstate/3``, ...).
  The keys equal the JAX store's ``tree_flatten_with_path`` keys, so a
  directory written by either package restores in the other.
* **Exotic dtypes**: a ``torch.bfloat16`` leaf is written as ``uint16`` and a
  ``float8_e4m3fn`` / ``float8_e5m2`` leaf as ``uint8``, through torch views;
  the manifest keeps the logical dtype name, as the JAX store's
  ``ml_dtypes`` path does.  A host ``int`` / ``float`` / ``bool`` leaf (the
  fused loop's ``tick``) is written as a 0-d int32 / float64 / bool array and
  restored as a Python scalar.
* **Atomic**: writes go to ``<dir>.tmp`` and are renamed when complete;
  :meth:`CheckpointStore.latest_step` counts complete manifests only.
* **Async**: :meth:`CheckpointStore.save_async` copies every leaf to host
  memory before it returns (the fused loop updates its carry in place, so a
  view of a CPU tensor would change under the writer) and writes on a
  background thread, one save in flight at a time.
* **Sharded carries**: ``CheckpointStore(directory, mesh=mesh)`` is the
  store every rank of a fleet mesh opens on one directory, for trees whose
  tensor leaves are each rank's shard of the batch axis (dim 0), as a
  sharded fused loop's carry is.  A save gathers the shards (a collective
  every rank joins) and the mesh's first rank writes the whole fleet's
  leaves, the layout an unsharded loop (or the JAX store) writes; a
  restore reads them and hands each rank its own block of lanes.  So a
  directory restores across layouts where the padded extents agree.
  :meth:`~CheckpointStore.save` and :meth:`~CheckpointStore.wait` end in
  a barrier of the mesh's ranks, so a restore after either reads a
  complete directory on every rank.
"""

from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..tree import flatten_with_paths as _flatten_with_paths
from ..tree import unflatten as _unflatten

__all__ = ["CheckpointStore"]

# Logical dtype -> (the torch dtype, the same-width carrier it is saved as).
_EXOTIC = {
    "bfloat16": (torch.bfloat16, torch.int16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.uint8, np.uint8),
}
_EXOTIC_BY_TORCH = {v[0]: k for k, v in _EXOTIC.items()}
# A host scalar leaf's 0-d array type (the JAX loop's tick is an int32 scalar).
_SCALARS = {bool: np.bool_, int: np.int32, float: np.float64}


def _host_copy(leaf) -> tuple[np.ndarray, str]:
    """A host numpy array that owns its memory, and the leaf's logical dtype
    name.  Exotic float leaves come back as their uint carrier."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        name = _EXOTIC_BY_TORCH.get(t.dtype)
        if name is not None:
            _, carrier, np_carrier = _EXOTIC[name]
            return t.view(carrier).to("cpu", copy=True).numpy().view(np_carrier), name
        arr = t.to("cpu", copy=True).numpy()
        return arr, arr.dtype.name
    if type(leaf) in _SCALARS:
        arr = np.asarray(leaf, dtype=_SCALARS[type(leaf)])
        return arr, arr.dtype.name
    arr = np.array(leaf)  # copies
    name = arr.dtype.name
    if name in _EXOTIC:  # an ml_dtypes array handed in by the caller
        arr = arr.view(_EXOTIC[name][2])
    return arr, name


def _restore_leaf(arr: np.ndarray, logical: str, want, key: str):
    """The saved array ``arr`` (its carrier for an exotic dtype) in the form
    of the template leaf ``want``: a fresh tensor on its device and dtype, a
    numpy array of its dtype, or a Python scalar of its type."""
    if isinstance(want, torch.Tensor):
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(
                f"shape mismatch for {key}: ckpt {arr.shape} vs template {tuple(want.shape)}")
        if logical in _EXOTIC:
            t = torch.from_numpy(np.ascontiguousarray(arr).view(
                np.int16 if logical == "bfloat16" else np.uint8)).view(_EXOTIC[logical][0])
        else:
            t = torch.from_numpy(np.ascontiguousarray(arr))
        return t.to(device=want.device, dtype=want.dtype, copy=True)
    if type(want) in _SCALARS:
        if arr.shape != ():
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs a scalar template")
        return type(want)(arr.item())
    want_arr = np.asarray(want)
    if tuple(arr.shape) != tuple(want_arr.shape):
        raise ValueError(
            f"shape mismatch for {key}: ckpt {arr.shape} vs template {want_arr.shape}")
    if want_arr.dtype.name in _EXOTIC:  # an ml_dtypes template: reinterpret the bits
        if logical != want_arr.dtype.name:
            raise ValueError(f"{key}: cannot cast a {logical} leaf to {want_arr.dtype.name}")
        return arr.view(want_arr.dtype)
    if logical in _EXOTIC:  # to a numpy dtype, through torch
        return _restore_leaf(arr, logical, torch.empty(arr.shape, dtype=torch.float32),
                             key).numpy().astype(want_arr.dtype)
    return arr.astype(want_arr.dtype)


class CheckpointStore:
    def __init__(self, directory: str | Path, *, mesh=None):
        self.dir = Path(directory)
        self.mesh = mesh
        self._writer = mesh is None or mesh.rank == 0
        if self._writer:
            self.dir.mkdir(parents=True, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self.save_count = 0

    def _barrier(self) -> None:
        if self.mesh is not None:
            self.mesh.barrier()

    # ------------------------------------------------------------------ #
    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:010d}"

    @staticmethod
    def _snapshot(tree: Any) -> list[tuple[str, np.ndarray, str]]:
        return [(key, *_host_copy(leaf)) for key, leaf in _flatten_with_paths(tree)]

    def _whole(self, tree: Any) -> Any:
        """Under a mesh, every tensor leaf's shards gathered along dim 0
        (every rank calls this); the tree itself without one."""
        if self.mesh is None:
            return tree
        leaves = {key: self.mesh.all_gather(leaf) if isinstance(leaf, torch.Tensor) else leaf
                  for key, leaf in _flatten_with_paths(tree)}
        return _unflatten(tree, leaves)

    def save(self, step: int, tree: Any, *, extra: dict | None = None) -> Path:
        """Synchronous atomic save."""
        tree = self._whole(tree)
        if self._writer:
            self._write(step, self._snapshot(tree), extra or {})
        self._barrier()
        return self._step_dir(step)

    def save_async(self, step: int, tree: Any, *, extra: dict | None = None) -> None:
        """Copy every leaf to host memory now, write on a background thread."""
        self.wait()  # one in-flight save at a time
        tree = self._whole(tree)
        if not self._writer:
            return
        host = self._snapshot(tree)  # device -> host copies, before returning
        self._thread = threading.Thread(
            target=self._write, args=(step, host, extra or {}), daemon=True
        )
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._barrier()

    def _write(self, step: int, host: list, extra: dict) -> Path:
        final = self._step_dir(step)
        tmp = final.with_suffix(".tmp")
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest: dict[str, Any] = {"step": step, "time": time.time(), "extra": extra,
                                    "leaves": {}}
        for key, arr, logical in host:
            fname = key.replace("/", "__") + ".npy"
            np.save(tmp / fname, arr)
            manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape),
                                       "dtype": logical}
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
        with self._lock:
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            self.save_count += 1
        return final

    # ------------------------------------------------------------------ #
    def latest_step(self) -> int | None:
        steps = []
        for d in self.dir.glob("step_*"):
            if d.is_dir() and (d / "manifest.json").exists():
                try:
                    steps.append(int(d.name.split("_")[1]))
                except ValueError:
                    continue
        return max(steps) if steps else None

    def restore(self, template: Any, step: int | None = None) -> tuple[Any, dict]:
        """Restore into the structure of ``template`` (tensors, numpy arrays or
        Python scalars).  Returns ``(tree, extra)``.  Each leaf takes the
        template's dtype (an explicit cast, so a float32 checkpoint restores
        onto a bfloat16 template) and, for a tensor, its device; every
        restored tensor is a new buffer.  Under a mesh a tensor leaf whose
        template holds ``1 / size`` of the saved lanes takes this rank's
        block of them."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self._step_dir(step)
        manifest = json.loads((d / "manifest.json").read_text())
        leaves: dict[str, Any] = {}
        for key, want in _flatten_with_paths(template):
            meta = manifest["leaves"].get(key)
            if meta is None:
                raise KeyError(f"checkpoint at step {step} missing leaf {key}")
            arr = np.load(d / meta["file"])
            if (self.mesh is not None and isinstance(want, torch.Tensor) and want.ndim
                    and arr.ndim and arr.shape[0] == want.shape[0] * self.mesh.size):
                arr = arr[self.mesh.shard(arr.shape[0])]
            leaves[key] = _restore_leaf(arr, meta["dtype"], want, key)
        return _unflatten(template, leaves), manifest.get("extra", {})

    def prune(self, keep: int = 3) -> int:
        """Delete all but the newest ``keep`` checkpoints."""
        dirs = sorted(
            (d for d in self.dir.glob("step_*") if (d / "manifest.json").exists()),
            key=lambda d: int(d.name.split("_")[1]),
        )
        removed = 0
        for d in dirs[:-keep] if keep else dirs:
            shutil.rmtree(d)
            removed += 1
        return removed
