"""Plain PyTorch version of the bounded-queue fluid step.

One discrete-time step of every (scenario, operator) queue lane:

    served   = min(q, cap_serve)             # drain the step-start backlog
    q1       = q - served
    space    = max(cap_queue - q1, 0)        # +inf lanes never shed (block /
    admitted = min(inflow, space)            #  unbounded queues)
    dropped  = inflow - admitted
    q_next   = q1 + admitted

Elementwise, so the lane axis carries scenarios x operators.  The dtype
follows ``q`` (float32 or float64).
"""

from __future__ import annotations

import torch

__all__ = ["queue_step"]


def queue_step(q, inflow, cap_serve, cap_queue):
    """[M] lanes -> (q_next, served, dropped), each [M]."""
    served = torch.minimum(q, cap_serve)
    q1 = q - served
    space = torch.clamp_min(cap_queue - q1, 0.0)
    admitted = torch.minimum(inflow, space)
    return q1 + admitted, served, inflow - admitted
