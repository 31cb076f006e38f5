"""Wrappers of the CUDA bounded-queue kernels (``csrc/queue_step.cu``):
``queue_step``, the Hopper counterpart of
``repro/kernels/queue_step/kernel.py:queue_step_pallas``, and
``queue_window``, which runs a whole control window of those steps (the
routing hop and the window sums too) in one launch.

:func:`plan` picks the window kernel's route from N (see its docstring);
every route gives the same bits as ``ref.queue_window``."""

from __future__ import annotations

import torch

from .. import _build

__all__ = ["queue_step", "queue_window", "plan", "WIDE_MAX_N"]

#: The wide route (one block per scenario, N > 32) runs a thread per lane.
WIDE_MAX_N = 1024
_LANE_PLANES, _SCEN_PLANES = 11, 4
_ROUTES = {"segment": 0, "wide": 1}


def plan(n: int) -> tuple[str, int]:
    """``(route, width)`` of the window kernel for ``n`` operator lanes.

    - ``"segment"`` (``n <= 32``): scenarios packed in warp segments of
      ``width`` lanes, 8 up to ``n = 8`` (the fleet's N 7: four scenarios
      per warp), else 32; one lane per operator holding its routing
      column, ``served_prev`` and the row sums moved by segmented shuffles
      in index order;
    - ``"wide"`` (``n > 32``): one block per scenario, a thread per lane
      (``width`` = ``n`` rounded up to whole warps), ``served_prev`` in
      shared memory.  A choice by shape: 33 or more lanes fill a warp.
    """
    if n < 1:
        raise ValueError(f"queue_window: N must be >= 1, got {n}")
    if n <= 32:
        return "segment", 8 if n <= 8 else 32
    return "wide", -(-n // 32) * 32


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


def queue_window(q, served_prev, ext, warm, cap_serve, cap_queue, routing):
    """One control window in one launch: float32 CUDA ``q, served_prev,
    cap_serve, cap_queue`` [B, N], ``ext`` [T, B, N], ``warm`` [T],
    ``routing`` [B, N, N] -> the 15 outputs of ``ref.queue_window``, bit
    for bit (views of two fresh buffers)."""
    if q.ndim != 2:
        raise ValueError(f"q must be [B, N], got shape {tuple(q.shape)}")
    b, n = q.shape
    if ext.ndim != 3:
        raise ValueError(f"ext must be [T, B, N], got shape {tuple(ext.shape)}")
    steps = ext.shape[0]
    route, width = plan(n)
    if n > WIDE_MAX_N:
        raise ValueError(f"queue_window: N={n} lanes exceed one block ({WIDE_MAX_N})")
    dev = q.device
    for name, t, shape in (("q", q, (b, n)), ("served_prev", served_prev, (b, n)),
                           ("ext", ext, (steps, b, n)), ("warm", warm, (steps,)),
                           ("cap_serve", cap_serve, (b, n)), ("cap_queue", cap_queue, (b, n)),
                           ("routing", routing, (b, n, n))):
        _build.require(f"queue_window {name}", t, torch.float32, shape, device=dev)
    lane = torch.empty((_LANE_PLANES, b, n), dtype=torch.float32, device=dev)
    scen = torch.empty((_SCEN_PLANES, b), dtype=torch.float32, device=dev)
    lib = _build.library()
    dev_idx, stream = _build.launch_args(q)
    code = lib.repro_queue_window(
        q.data_ptr(), served_prev.data_ptr(), ext.data_ptr(), warm.data_ptr(),
        cap_serve.data_ptr(), cap_queue.data_ptr(), routing.data_ptr(),
        lane.data_ptr(), scen.data_ptr(), b, n, steps, _ROUTES[route], width, dev_idx, stream,
    )
    _build.check_error("queue_window", code)
    _build.count_launch("queue_window")
    (q1, sp1, off, srv, drop, q_int, q_max, w_off, w_srv, w_drop, w_qi) = lane.unbind(0)
    ea, eo, w_ea, w_eo = scen.unbind(0)
    return (q1, sp1, off, srv, drop, ea, eo, q_int, q_max, w_off, w_srv, w_drop, w_ea,
            w_eo, w_qi)
