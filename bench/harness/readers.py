"""Arithmetic that several metric readers share.  A reader returns None
where the run has nothing for it to read (no trace, no such kernel on the
path); it never returns 0 for a share of a roofline or of a peak."""

from __future__ import annotations

import numpy as np

from .cell import Run, bound_total
from .yardstick import bound_s


def tokens_per_s(run: Run, kind: str):
    if run.kind != kind or not run.calls or run.window_s <= 0:
        return None
    return sum(c["tokens"] for c in run.calls) / run.window_s


def step_ms_p95(run: Run):
    if run.kind != "decode" or not run.calls:
        return None
    return float(np.percentile([c["t"] * 1e3 for c in run.calls], 95))


def step_mfu(run: Run, kind: str):
    """The least time on the card over the time taken, in %: each call's
    model FLOPs over the bf16 peak or its bytes over the HBM bandwidth,
    whichever is larger, summed over the calls, over their seconds.  The
    calls are the window's where each call's work is known from its sizes
    alone; a mixture of experts counts the pairs it kept, which only the
    traced segment's calls record, so there the traced calls and their own
    host times are read."""
    if run.kind != kind:
        return None
    moe = run.dims.experts > 0
    if run.calls and all("moe" in c or not moe for c in run.calls) and run.window_s > 0:
        return 100.0 * bound_total(run, run.calls) / run.window_s
    calls = run.traced_calls
    if not calls or not all("moe" in c or not moe for c in calls):
        return None
    return 100.0 * bound_total(run, calls) / sum(c["t"] for c in calls)


def kernel_roofline(run: Run, kind: str, names: tuple, launch_key: str, work) -> float | None:
    """A kernel's bound over its device time in the traced segment, in %.

    ``work(run, call)`` gives the (bytes, operations) of all the kernel's
    calls within one traced call, from the model's structure; ``names`` pick
    the kernel's device records by name; ``launch_key`` is its wrapper's
    name in the program's launch counter, which counts one launch a kernel
    run.  Where the records that ``names`` pick are not as many as the
    counter's launches in the segment (the profiler lost some, or the
    kernel's name changed), there is no time to read: None."""
    tl = run.timeline
    launches = run.launches.get(launch_key, 0)
    if run.kind != kind or tl is None or not launches:
        return None
    ops = tl.kernels(*names)
    busy = sum(e - s for _n, _c, s, e in ops)
    if len(ops) != launches or busy <= 0:
        return None
    bound = sum(bound_s(*work(run, c)) for c in run.traced_calls)
    return 100.0 * bound / busy


def idle_share(run: Run, kind: str):
    """The traced segment's share with no device operation running, in %.
    The segment runs under CPU-side profiling as well (the breakdown names
    the host's operation in each gap), so the profiler's own host cost is
    in it: small where the card paces the calls."""
    tl = run.timeline
    if run.kind != kind or tl is None or tl.window_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s() / tl.window_s)
