"""The prefill calls' share of the card's peak, in %: each call's model
FLOPs over 989 TFLOP/s or its bytes over 3.35 TB/s, whichever is larger,
summed, over the calls' seconds: the window's calls, or for a mixture of
experts (whose kept pairs only the traced calls record) the traced
segment's."""

from bench.harness.readers import step_mfu


def read(run):
    return step_mfu(run, "prefill")
