"""Decode attention's share of its roofline in the traced decode steps, in
%: one call a layer over the step's cached rows (at most the sliding
window's), its bound from the frozen ``decode_work``, over the device time
of the kernels named below, which run once for each launch that the
program's ``decode_attention`` counter counts."""

from bench.harness.readers import kernel_roofline
from bench.harness.yardstick import decode_work

KERNELS = ("decode_",)


def work(run, call):
    m = run.dims
    keys = min(call["keys"], m.window or call["keys"])
    nbytes, flops = decode_work(call["b"], m.hq, m.hkv, m.dh, keys)
    return m.layers * nbytes, m.layers * flops


def read(run):
    return kernel_roofline(run, "decode", KERNELS, "decode_attention", work)
