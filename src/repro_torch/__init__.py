"""PyTorch / CUDA port of the DRS control plane and the workloads it runs.

The JAX package ``repro`` stays the reference; this package runs, in
PyTorch, the batched closed control loop (simulate -> measure -> decide ->
apply over B scenarios x N operators; fused, or window at a time with the
float64 twin decide and negotiated machine leases), the discrete-event
simulator behind ``DRSSession.bind(graph, "des")`` and the serving
simulation on it, the live DRS session with the VLD application, and LLM
serving for the dense (llama3.2-1b), ssm (rwkv6-1.6b) and hybrid
(zamba2-7b) families, with every TPU kernel on those paths rewritten as
CUDA C++ for Hopper (``csrc/``).  It imports neither JAX nor ``repro``.

Entry points -- :class:`~repro_torch.api.session.ScenarioRunner`,
:func:`~repro_torch.streaming.scenarios.control_trace`,
:func:`~repro_torch.core.controller.make_fused_loop`,
:func:`~repro_torch.core.controller.make_decide`,
:class:`~repro_torch.api.session.DRSSession` and the serving functions of
:mod:`repro_torch.models.serve` -- run on the CUDA device unless given
``device="cpu"``, where every kernel call takes its plain PyTorch version.
The host paths -- the DES, ``backend="numpy"`` twins -- need no card.
"""
