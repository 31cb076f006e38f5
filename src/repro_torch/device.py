"""Where the port runs: the CUDA device unless the caller asks otherwise."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device.  Raises when a CUDA device is asked
    for (explicitly or by default) and none is available: the entry points
    never carry on on the CPU by themselves -- pass ``device="cpu"`` to run
    the plain PyTorch versions there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the CUDA device by default and no CUDA device "
            "is available; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
