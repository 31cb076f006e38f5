"""The SwiGLU kernel's share of its roofline in the traced prefill calls, in
%: one SwiGLU a layer over the call's tokens, its bound from the frozen
``swiglu_work``, over the device time of the kernels named below, which run
once for each launch that the program's ``swiglu`` counter counts (two a
call: the gate and up product, then the down product)."""

from bench.harness.readers import kernel_roofline
from bench.harness.yardstick import swiglu_work

KERNELS = ("swiglu_",)


def work(run, call):
    m = run.dims
    nbytes, flops = swiglu_work(call["b"] * call["s"], m.d, m.f)
    return m.layers * nbytes, m.layers * flops


def read(run):
    if run.dims.experts:
        return None
    return kernel_roofline(run, "prefill", KERNELS, "swiglu", work)
