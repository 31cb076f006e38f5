"""Reading the device's timeline from one ``torch.profiler`` session.

The session records the host (operators, the CUDA runtime's calls, the
harness's own spans) and the device (kernels, copies, sets).  From its
Chrome trace this module takes every device operation's interval, the
kernel launches the host made, and the harness's ``bench.segment`` span,
which bounds the traced window.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field

SEGMENT = "bench.segment"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                 "cudaLaunchCooperativeKernel")


@dataclass
class Timeline:
    """Intervals in seconds from the segment's start."""

    window_s: float
    ops: list = field(default_factory=list)  # (name, category, start, end) on the device
    host: list = field(default_factory=list)  # (name, start, end): host operators and spans
    launches: int = 0  # the host's kernel launch calls in the window
    dropped: int = 0  # of those, launches whose kernel the profiler did not record

    def __post_init__(self):
        self.sort()

    def sort(self):
        self.host.sort(key=lambda h: h[1])
        self._starts = [h[1] for h in self.host]

    def kernels(self, *names: str) -> list:
        """The kernels whose names contain one of ``names``."""
        return [o for o in self.ops if o[1] == "kernel" and any(n in o[0] for n in names)]

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (the union)."""
        busy, end = 0.0, 0.0
        for _n, _c, s, e in sorted(self.ops, key=lambda o: o[2]):
            s, e = max(s, end, 0.0), min(e, self.window_s)
            if e > s:
                busy += e - s
                end = e
        return busy

    def gaps(self) -> list:
        """(start, end) of each stretch with no device operation."""
        out, end = [], 0.0
        for _n, _c, s, e in sorted(self.ops, key=lambda o: o[2]):
            if s > end:
                out.append((end, min(s, self.window_s)))
            end = max(end, e)
        if end < self.window_s:
            out.append((end, self.window_s))
        return [g for g in out if g[1] > g[0]]

    def host_at(self, t: float, depth: int = 2000) -> str:
        """The innermost host operator or span running at ``t``: of those that
        contain it, the one that started last (``host`` is sorted by start)."""
        i = bisect.bisect_right(self._starts, t) - 1
        for name, _s, e in reversed(self.host[max(0, i - depth):i + 1]):
            if e >= t and name != SEGMENT:
                return name
        return "host (nothing recorded)"

    def breakdown(self, top: int = 10) -> dict:
        by_op: dict = {}
        for name, _c, s, e in self.ops:
            by_op[name] = by_op.get(name, 0.0) + (e - s)
        by_gap: dict = {}
        for s, e in self.gaps():
            label = self.host_at(s + min(e - s, 2e-6))
            by_gap[label] = by_gap.get(label, 0.0) + (e - s)

        def head(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": head(by_op), "idle_gaps": head(by_gap)}


def read(prof) -> Timeline:
    """The timeline of a finished ``torch.profiler.profile`` session."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)
    events = events["traceEvents"] if isinstance(events, dict) else events
    seg = [e for e in events if e.get("name") == SEGMENT and e.get("ph") == "X"
           and e.get("cat") in ("user_annotation", "cpu_instant_event", "python_function",
                                "cpu_op")]
    if not seg:
        raise RuntimeError("trace: no bench.segment span recorded")
    t0 = float(seg[0]["ts"])
    t1 = t0 + float(seg[0]["dur"])
    tl = Timeline(window_s=(t1 - t0) * 1e-6)
    launched, ran = set(), set()
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = (float(e["ts"]) - t0) * 1e-6
        end = s + float(e["dur"]) * 1e-6
        cat = e.get("cat", "")
        corr = (e.get("args") or {}).get("correlation")
        if cat in _DEVICE_CATS:
            ran.add(corr)
            if end > 0 and s < tl.window_s:
                tl.ops.append((e.get("name", "?"), cat, s, end))
        elif cat == "cuda_runtime":
            if e.get("name") in _LAUNCH_NAMES and 0 <= s <= tl.window_s:
                tl.launches += 1
                launched.add(corr)
            tl.host.append((e.get("name", "?"), s, end))
        elif cat in ("cpu_op", "user_annotation"):
            tl.host.append((e.get("name", "?"), s, end))
    tl.dropped = len(launched - ran)
    tl.sort()
    return tl
