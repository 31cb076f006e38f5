"""Wrapper of the CUDA bounded-queue step (``csrc/queue_step.cu``), the
Hopper counterpart of ``repro/kernels/queue_step/kernel.py:queue_step_pallas``."""

from __future__ import annotations

import torch

from .. import _build

__all__ = ["queue_step"]


def queue_step(q, inflow, cap_serve, cap_queue):
    """[M] float32 CUDA lanes -> (q_next, served, dropped), each [M] float32."""
    if q.ndim != 1:
        raise ValueError(f"q must be 1-D, got shape {tuple(q.shape)}")
    for name, t in (("q", q), ("inflow", inflow), ("cap_serve", cap_serve),
                    ("cap_queue", cap_queue)):
        _build.require(f"queue_step {name}", t, torch.float32, q.shape, device=q.device)
    outs = [torch.empty_like(q) for _ in range(3)]
    lib = _build.library()
    dev, stream = _build.launch_args(q)
    code = lib.repro_queue_step(
        q.data_ptr(), inflow.data_ptr(), cap_serve.data_ptr(), cap_queue.data_ptr(),
        outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(),
        q.numel(), dev, stream,
    )
    _build.check_error("queue_step", code)
    _build.count_launch("queue_step")
    return tuple(outs)
