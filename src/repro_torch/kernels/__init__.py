"""Hand-written Hopper kernels of the control loop, one package each.

Every kernel keeps three faces, as in the JAX package's ``repro.kernels``:

* ``kernel.py`` -- the wrapper of the CUDA C++ kernel (``csrc/*.cu``):
  checks device, dtype, shape and contiguity, allocates the outputs,
  launches on the current stream and counts the launch;
* ``ref.py`` -- the plain PyTorch version of the same function;
* ``ops.py`` -- dispatch: a CUDA tensor goes to the kernel (which raises
  rather than falling back), a CPU tensor to the plain version.

``LAUNCHES`` (a :class:`collections.Counter`) counts launches per kernel
name; ``LAUNCHES.clear()`` resets it.
"""

from ._build import LAUNCHES

__all__ = ["LAUNCHES", "KERNELS"]

#: The kernels of the control-loop slice, by launch-counter name.
KERNELS = ("queue_step", "erlang_c", "gain_topr", "decide_fused")
