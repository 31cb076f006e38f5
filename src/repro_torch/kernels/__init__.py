"""Hand-written Hopper kernels of the control loop, the VLD matcher and the
LLM serving paths, one package each.

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

__all__ = ["LAUNCHES", "KERNELS", "VLD_KERNELS", "LLM_KERNELS", "SSM_KERNELS"]

#: The kernels of the control-loop slice, by launch-counter name
#: (``queue_window`` runs a tick's window of steps; the single-step
#: ``queue_step`` is on no path).
KERNELS = ("queue_step", "queue_window", "erlang_c", "gain_topr", "decide_fused")

#: The kernels of the live VLD matcher (``pairwise_sq_l2`` shares its
#: distance tile with ``match_count``; no path of the port calls it).
VLD_KERNELS = ("pairwise_sq_l2", "match_count")

#: The kernels of the LLM serving path (``swiglu`` and ``moe_experts``, the
#: routed experts' grouped SwiGLU, count both of their launches); zamba2's
#: shared attention block runs the first three too.
LLM_KERNELS = ("flash_attention", "decode_attention", "swiglu", "moe_experts")

#: The chunked scans of the ssm (rwkv6) and hybrid (zamba2) families; their
#: serving paths also run ``LLM_KERNELS`` (zamba2's shared block).
SSM_KERNELS = ("rwkv6_scan", "ssd_scan")
