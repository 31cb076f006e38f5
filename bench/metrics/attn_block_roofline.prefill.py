"""The attention blocks' share of their roofline in the traced prefill calls,
in %: each layer's pre-norm, Q / K / V and output projections, RoPE,
attention and residual, bound by the projections' and the causal (windowed)
pairs' operations (``blocks.attn_block_work``), over the device time of the
program's ``layer.attn`` spans."""

from bench.harness.blocks import attn_block_work
from bench.harness.spans import block_roofline


def work(run, call, counters):
    return attn_block_work(run.dims, call["b"], call["s"])


def read(run):
    return block_roofline(run, "layer.attn", work)
