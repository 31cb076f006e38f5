"""The program's own record of the traced segment's calls: the spans and
counters of ``repro_torch.obs``, which records while the segment's
profiler session runs (and not in the window, the warm-up or the check's
replay).  A program without that module, or a segment whose records lack a
device time (on the CPU), gives None."""

from __future__ import annotations

from .cell import Run
from .yardstick import bound_s


def records(run: Run, root: str) -> list | None:
    """The last ``len(run.traced_calls)`` records, each a call whose root
    span is ``root``, or None where there are fewer or a span has no
    device time."""
    n = len(run.traced_calls)
    if not n:
        return None
    try:
        from repro_torch import obs
    except ImportError:
        return None
    got = obs.calls()[-n:]
    if len(got) < n or any(r["name"] != root for r in got):
        return None
    if any(s["device_ms"] is None for r in got for s in r["spans"]):
        return None
    return got


def device_s(rec: dict, name: str) -> float:
    """Seconds on the card of one call's spans named ``name``, summed."""
    return 1e-3 * sum(s["device_ms"] for s in rec["spans"] if s["name"] == name)


def block_roofline(run: Run, span: str, work) -> float | None:
    """A block's bound over its spans' device time in the traced prefill
    calls, in %.  ``work(run, call, counters)`` gives the (bytes,
    operations) of the block in all the layers of one traced call (``call``
    the harness's record of it, ``counters`` the program's); None where a
    call has no such span or ``work`` finds nothing to count."""
    recs = records(run, "serve.prefill") if run.kind == "prefill" else None
    if recs is None:
        return None
    bound = busy = 0.0
    for call, rec in zip(run.traced_calls, recs):
        w = work(run, call, rec["counters"])
        t = device_s(rec, span)
        if w is None or t <= 0:
            return None
        bound += bound_s(*w)
        busy += t
    return 100.0 * bound / busy
