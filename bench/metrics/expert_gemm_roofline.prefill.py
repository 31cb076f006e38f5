"""The routed experts' GEMMs' share of their roofline in the traced prefill
calls, in %: the kept pairs' three products a layer (the program's
``moe.pairs_kept`` counter; the padded capacity's slots are computed but not
counted) and every expert's weights (``blocks.expert_gemm_work``), over the
device time of the program's ``moe.experts`` spans."""

from bench.harness.blocks import expert_gemm_work
from bench.harness.spans import block_roofline


def work(run, call, counters):
    m = run.dims
    if counters.get("moe.pairs_routed") != m.layers * call["b"] * call["s"] * m.top_k:
        return None
    return expert_gemm_work(m, counters["moe.pairs_kept"])


def read(run):
    if not run.dims.experts:
        return None
    return block_roofline(run, "moe.experts", work)
