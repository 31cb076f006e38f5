"""Flash attention's share of its roofline in the traced prefill calls, in
%: one causal call a layer (within the configuration's sliding window, if
any), its bound from the frozen ``flash_work``, over the device time of the
kernels named below, which run once for each launch that the program's
``flash_attention`` counter counts."""

from bench.harness.readers import kernel_roofline
from bench.harness.yardstick import flash_work

KERNELS = ("flash_",)


def work(run, call):
    m = run.dims
    nbytes, flops = flash_work(call["b"], m.hq, m.hkv, call["s"], call["s"], m.dh,
                               window=m.window)
    return m.layers * nbytes, m.layers * flops


def read(run):
    return kernel_roofline(run, "prefill", KERNELS, "flash_attention", work)
