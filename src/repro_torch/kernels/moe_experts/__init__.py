"""The routed experts' grouped SwiGLU over the filled slots of a capacity
buffer (kernel / plain version); ``models/ffn.py`` chooses between it and
the padded ``torch.bmm`` products."""

from .kernel import MIN_SLOTS, ROW_TILE, experts, run_rows

__all__ = ["MIN_SLOTS", "ROW_TILE", "experts", "run_rows"]
