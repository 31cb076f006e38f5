"""The FFN blocks' share of their roofline in the traced prefill calls, in
%: each layer's pre-norm, dense SwiGLU or whole MoE layer (router, dispatch,
the routed experts' GEMMs, combine) and residual, bound by the SwiGLU's or
the router's and the kept pairs' operations (``blocks.ffn_block_work``; the
kept pairs from the program's ``moe.pairs_kept`` counter), over the device
time of the program's ``layer.ffn`` spans."""

from bench.harness.blocks import ffn_block_work
from bench.harness.spans import block_roofline


def work(run, call, counters):
    m = run.dims
    t = call["b"] * call["s"]
    if not m.experts:
        return ffn_block_work(m, t)
    if counters.get("moe.pairs_routed") != m.layers * t * m.top_k:
        return None
    return ffn_block_work(m, t, counters["moe.pairs_kept"])


def read(run):
    return block_roofline(run, "layer.ffn", work)
