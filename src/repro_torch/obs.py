"""Spans and counters of the serving path: where a prefill call's or a
decode step's time goes on the card, and how many (token, expert) pairs
its MoE layers kept.

Recording is on while a ``torch.profiler`` session records, and inside
``with obs.recording():``; there is no other switch.  Off, each span and
counter is one check of those two flags and does nothing else.

Spans (a name, a host start and end from ``time.perf_counter_ns``, and a
device duration from two timing CUDA events recorded on the current stream
at enter and exit; ``None`` on the CPU):

  ``serve.prefill`` / ``serve.decode_step``  one per call of
        :func:`repro_torch.models.serve.prefill` / ``decode_step``: the
        root, which opens the call's record;
  ``layer.attn``   a layer's pre-norm, QKV projections, RoPE, attention,
        output projection and residual (decode: the cache write too);
  ``layer.ffn``    a layer's pre-norm, dense SwiGLU or whole MoE layer, and
        residual;
  ``moe.experts``  the routed experts' GEMMs of a MoE layer (under
        ``layer.ffn``).

A span's ``layer`` is its ordinal among the call's spans of its name (a
decoder layer's index for ``layer.attn`` / ``layer.ffn``, the MoE layer's
for ``moe.experts``) and ``parent`` the index of the span it opened in.
While a profiler records, every span also enters
``torch.profiler.record_function(name)``, so the profiler's timeline shows
it on the clock of the kernels it launched.  Spans run outside a call
(training's forward and recompute) only enter ``record_function``.

Counters, summed over a call's MoE layers: ``moe.pairs_kept`` (pairs
within their expert's capacity: each layer's keep mask is held and summed
when the record is read, so the call does no extra work and no host sync)
and ``moe.pairs_routed`` (T x k a layer); on the card also ``moe.slots``
(E x capacity a layer: the rows of the experts' buffer) and
``moe.slots_run`` (the rows inside the row tiles the experts' products
ran: each expert's filled slots rounded up to the grouped kernels' 128-row
tile on their path, a device tensor summed when the record is read like
the keep mask; every slot on the ``torch.bmm`` path), whose ratio shows how
much of the padded capacity the skip left out.  Kernel launches are counted by
:data:`repro_torch.kernels.LAUNCHES`.

The last :data:`KEEP` calls' records stay in memory; :func:`calls` returns
them, oldest first, resolving the events and the device counters, so call
it once the card has finished the calls (``torch.cuda.synchronize()``).
A record gives the measured service rates that ``python -m
repro_torch.launch.serve --prefill-rate / --decode-rate`` take: B prompts
over a ``serve.prefill`` record's root ``device_ms`` / 1e3 is the prefill
rate in prompts per second per chip, and B tokens over a
``serve.decode_step`` record's the decode rate in tokens per second.  The
device time is the card's own; the host's ``end_ns - start_ns`` is only
the enqueue.  For example::

    with obs.recording():
        for _ in range(8):
            logits, cache = serve.prefill(params, cfg, {"tokens": tokens}, cache)
        torch.cuda.synchronize()
    ms = [c["spans"][0]["device_ms"] for c in obs.calls()[-8:]]
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch
from torch.profiler import record_function

from .device import resolve_device

__all__ = ["KEEP", "recording", "enabled", "call", "span", "count", "calls"]

#: Calls whose records are kept (the oldest is dropped first).
KEEP = 64

_RECORDS: collections.deque = collections.deque(maxlen=KEEP)
_OFF = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled
_local = threading.local()
_lock = threading.Lock()
_forced = 0


def enabled() -> bool:
    """Whether spans and counters record now."""
    return _forced > 0 or _profiling()


@contextlib.contextmanager
def recording():
    """Record spans and counters inside the block, with no profiler."""
    global _forced
    with _lock:
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1


def call(name: str, device=None):
    """The root span of one call on ``device`` (resolved as the serving
    entry points resolve it); it opens the call's record, or is a plain
    span inside a call already open."""
    if not enabled():
        return _OFF
    return _Scope(name, device, root=True)


def span(name: str):
    """A span inside the open call."""
    if not enabled():
        return _OFF
    return _Scope(name)


def count(name: str, n) -> None:
    """Add ``n`` (an int, or a tensor whose sum is added when the record is
    read) to the open call's counter ``name``."""
    if not enabled():
        return
    rec = getattr(_local, "call", None)
    if rec is not None:
        rec.counters.setdefault(name, []).append(n)


def calls() -> list[dict]:
    """The kept records, oldest first: ``{"name", "spans", "counters"}``,
    ``spans`` a list of ``{"name", "layer", "parent", "start_ns",
    "end_ns", "device_ms"}`` in the order they opened (the root first,
    ``parent`` None), ``counters`` ints."""
    return [r.resolve() for r in list(_RECORDS)]


class _Call:
    """One call's spans and counters while it runs."""

    def __init__(self, device):
        dev = resolve_device(device)
        self.stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        self.spans: list = []  # [name, layer, parent, start, end, start event, end event]
        self.open: list = []  # indices of the spans open now, innermost last
        self.seen: dict = {}
        self.counters: dict = {}  # name -> the ints and tensors added
        self.done = None

    def enter(self, name: str) -> int:
        layer = self.seen[name] = self.seen.get(name, -1) + 1
        ev = None
        if self.stream is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(self.stream)
        i = len(self.spans)
        self.spans.append([name, layer, self.open[-1] if self.open else None,
                           time.perf_counter_ns(), None, ev, None])
        self.open.append(i)
        return i

    def exit(self, i: int) -> None:
        s = self.spans[i]
        if s[5] is not None:
            s[6] = torch.cuda.Event(enable_timing=True)
            s[6].record(self.stream)
        s[4] = time.perf_counter_ns()
        self.open.pop()

    def resolve(self) -> dict:
        if self.done is None:
            if self.stream is not None:
                self.spans[0][6].synchronize()
            self.done = {
                "name": self.spans[0][0],
                "spans": [{"name": n, "layer": layer, "parent": p, "start_ns": t0,
                           "end_ns": t1, "device_ms": None if e0 is None else e0.elapsed_time(e1)}
                          for n, layer, p, t0, t1, e0, e1 in self.spans],
                "counters": {k: sum(int(n.sum()) if isinstance(n, torch.Tensor) else n
                                    for n in parts) for k, parts in self.counters.items()},
            }
            self.spans = self.counters = None
        return self.done


class _Scope:
    """A recording span: ``record_function(name)`` while a profiler records
    and, inside a call, the call's record."""

    __slots__ = ("name", "device", "root", "rf", "rec", "index", "owner")

    def __init__(self, name: str, device=None, root: bool = False):
        self.name, self.device, self.root = name, device, root

    def __enter__(self):
        rec = getattr(_local, "call", None)
        self.owner = rec is None and self.root
        if self.owner:
            rec = _local.call = _Call(self.device)
        self.rec = rec
        self.rf = record_function(self.name) if _profiling() else None
        if self.rf is not None:
            self.rf.__enter__()
        if rec is not None:
            self.index = rec.enter(self.name)
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec.exit(self.index)
        if self.owner:
            _local.call = None
            _RECORDS.append(self.rec)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False
