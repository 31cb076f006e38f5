"""Seconds from the process's start to the window's first call: imports,
the kernels' build or load, the weights, the traffic, the decode cells'
prefill, the warm-up."""


def read(run):
    return run.setup_s
