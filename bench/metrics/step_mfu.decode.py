"""The decode steps' share of the card's peak, in %: each step's model
FLOPs over 989 TFLOP/s or its bytes (weights of the experts used, cache
rows read and written) over 3.35 TB/s, whichever is larger, summed, over
the window's seconds."""

from bench.harness.readers import step_mfu


def read(run):
    return step_mfu(run, "decode")
