"""PyTorch / CUDA port of the DRS control plane.

The JAX package ``repro`` stays the reference; this package runs the same
batched closed control loop (simulate -> measure -> decide -> apply over B
scenarios x N operators) in PyTorch, with its four TPU kernels rewritten
as CUDA C++ for Hopper (``csrc/``).  It imports neither JAX nor ``repro``.

Entry points -- :class:`~repro_torch.api.session.ScenarioRunner`,
:func:`~repro_torch.streaming.scenarios.control_trace`,
:func:`~repro_torch.core.controller.make_fused_loop` and
:func:`~repro_torch.core.controller.make_decide` -- run on the CUDA device
unless given ``device="cpu"``, where every kernel call takes its plain
PyTorch version.
"""
