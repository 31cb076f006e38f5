"""Live streaming engine (the stream platform layer, paper §IV), the port
of ``repro/streaming/engine.py``.

Each operator instance is a worker thread pulling tuples from the
operator's shared bounded input queue, applying the operator's compute and
emitting derived tuples downstream; an operator's parallelism is its
number of workers, ``k_i``, and the DRS scheduler rescales an operator by
starting or stopping workers (the paper's cheap rebalance: only the
resized operator's workers change).

On a CUDA device each worker launches on a CUDA stream of its own and,
after the operator's ``fn`` returns, waits for that stream before it stops
its service clock: the measured service time is then the device work, not
just the time to launch it, so the measurer's mu_hat places processors by
what the operator really costs.  A worker's emissions are complete on the
device before they are queued downstream.

Completion tracking mirrors Storm's acker: every external tuple carries a
root id with an outstanding count; when the count drains to zero the
measurer is told the complete sojourn time.  When a queue is full the
:class:`~repro_torch.streaming.overload.OverloadPolicy` decides whether
the producer blocks (backpressure up to :meth:`StreamEngine.inject`) or a
tuple is shed; a root whose tree lost any tuple counts as *shed*, not
completed.  An ``fn`` that raises drops its tuple (the root still
completes), as in the reference; the engine counts such failures per
operator in :attr:`StreamEngine.failures` and keeps the last one.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from ..core.measurer import Measurer
from ..device import resolve_device
from .overload import OverloadPolicy

__all__ = ["StreamTuple", "Operator", "StreamEngine"]


@dataclass
class _RootState:
    t_arrival: float
    outstanding: int = 0
    shed: bool = False  # any tuple of this root's tree was dropped
    lock: threading.Lock = field(default_factory=threading.Lock)


@dataclass
class StreamTuple:
    payload: Any
    root_id: int
    t_emit: float


class Operator:
    """A named operator: fn(payload) -> list of (downstream_name, payload).

    ``fn`` runs inside worker threads (PyTorch releases the GIL inside its
    kernels); it may return [] (a sink).
    """

    def __init__(self, name: str, fn: Callable[[Any], list[tuple[str, Any]]]):
        self.name = name
        self.fn = fn


class StreamEngine:
    """Topology runtime with per-operator worker pools.

    ``device`` (default: the CUDA device, raising without one) is where the
    workers launch; on a CUDA device each worker owns a stream.
    """

    def __init__(
        self,
        operators: list[Operator],
        *,
        measurer: Measurer | None = None,
        queue_capacity: int | None = 10_000,
        overload_policy: OverloadPolicy | str = "block",
        device=None,
    ):
        self.device = resolve_device(device)
        self.operators = {op.name: op for op in operators}
        self.names = [op.name for op in operators]
        self.measurer = measurer or Measurer(self.names)
        if queue_capacity is not None and queue_capacity < 1:
            raise ValueError(
                f"queue_capacity must be >= 1 or None (unbounded), got "
                f"{queue_capacity}"
            )
        self.queue_capacity = queue_capacity
        self.overload_policy = OverloadPolicy.coerce(overload_policy)
        maxsize = 0 if queue_capacity is None else queue_capacity
        self.queues: dict[str, queue.Queue] = {
            n: queue.Queue(maxsize=maxsize) for n in self.names
        }
        self._workers: dict[str, list[threading.Thread]] = {n: [] for n in self.names}
        self._worker_stop: dict[str, list[threading.Event]] = {n: [] for n in self.names}
        # Dedicated arrival probes (queue-tail measurement position, paper
        # Appendix C) — independent of worker lifecycle.
        self._arrival_probes = {n: self.measurer.new_probe(n) for n in self.names}
        self._roots: dict[int, _RootState] = {}
        self._roots_lock = threading.Lock()
        self._root_ids = itertools.count()
        self._stop = threading.Event()
        self.completed_sojourns: list[float] = []
        self._completed_lock = threading.Lock()
        # Cumulative per-operator shed counts (probes drain-reset on every
        # measurer pull, so the engine keeps its own running totals too).
        self._drops: dict[str, int] = {n: 0 for n in self.names}
        self._drops_lock = threading.Lock()
        self.shed_roots = 0  # external tuples whose tree lost >= 1 tuple
        # Per-operator count of fn calls that raised, and the last error.
        self.failures: dict[str, int] = {n: 0 for n in self.names}
        self.last_failure: BaseException | None = None

    # ------------------------------------------------------------------ #
    def k(self) -> dict[str, int]:
        return {n: len(self._workers[n]) for n in self.names}

    def drop_counts(self) -> dict[str, int]:
        """Cumulative tuples shed per operator since engine construction."""
        with self._drops_lock:
            return dict(self._drops)

    def scale_to(self, allocation: dict[str, int]) -> None:
        """Rescale operators to the given instance counts (cheap rebalance:
        only affected operators change; queues and other operators keep
        flowing)."""
        for name, target in allocation.items():
            cur = len(self._workers[name])
            if target > cur:
                for _ in range(target - cur):
                    self._start_worker(name)
            elif target < cur:
                for _ in range(cur - target):
                    ev = self._worker_stop[name].pop()
                    ev.set()  # worker exits after its current tuple
                    self._workers[name].pop()

    def _start_worker(self, name: str) -> None:
        ev = threading.Event()
        probe = self.measurer.new_probe(name)
        t = threading.Thread(
            target=self._worker_loop, args=(name, ev, probe), daemon=True
        )
        self._worker_stop[name].append(ev)
        self._workers[name].append(t)
        t.start()

    # ------------------------------------------------------------------ #
    def inject(
        self, source: str, payload: Any, *, timeout: float | None = None
    ) -> int | None:
        """External tuple enters the system (spout emission).

        Under the ``block`` policy this call backpressures: it waits for
        queue space (up to ``timeout`` seconds; ``None`` = indefinitely).
        Returns the root id, or ``None`` when the tuple was shed at
        admission (shed policies, timeout expiry, or engine stop) — a shed
        external tuple is *not* counted as an external arrival, but is
        recorded in the source operator's drop counter.
        """
        root_id = next(self._root_ids)
        st = _RootState(t_arrival=time.perf_counter(), outstanding=1)
        with self._roots_lock:
            self._roots[root_id] = st
        deadline = None if timeout is None else time.perf_counter() + timeout
        tup = StreamTuple(payload, root_id, time.perf_counter())
        if not self._enqueue(source, tup, deadline=deadline):
            return None
        self.measurer.on_external_arrival()
        return root_id

    def _enqueue(
        self, name: str, tup: StreamTuple, *, deadline: float | None = None
    ) -> bool:
        """Offer a tuple to an operator queue under the overload policy.

        Counts the offered load at the queue tail (Appendix C) whether or
        not the tuple is admitted; returns False when it was shed.
        """
        self._arrival_probes[name].on_enqueue()
        q = self.queues[name]
        try:
            q.put_nowait(tup)
            return True
        except queue.Full:
            pass
        kind = self.overload_policy.kind
        if kind == "shed-newest":
            self._shed(name, tup)
            return False
        if kind == "shed-oldest":
            while True:
                try:
                    q.put_nowait(tup)
                    return True
                except queue.Full:
                    try:
                        evicted = q.get_nowait()
                    except queue.Empty:  # a worker beat us to the head
                        continue
                    self._shed(name, evicted)
        # block: wait for space, polling so engine stop / deadline unblocks.
        poll = self.overload_policy.block_poll
        while not self._stop.is_set():
            if deadline is not None and time.perf_counter() >= deadline:
                break
            try:
                q.put(tup, timeout=poll)
                return True
            except queue.Full:
                continue
        self._shed(name, tup)
        return False

    def _shed(self, name: str, tup: StreamTuple) -> None:
        """Drop a tuple at operator ``name``: count it and poison its root."""
        self._arrival_probes[name].on_dropped()
        with self._drops_lock:
            self._drops[name] += 1
        with self._roots_lock:
            root = self._roots.get(tup.root_id)
        if root is not None:
            with root.lock:
                root.shed = True
        self._complete_one(tup.root_id)

    def _worker_loop(self, name: str, stop: threading.Event, probe) -> None:
        op = self.operators[name]
        q = self.queues[name]
        stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        while not stop.is_set() and not self._stop.is_set():
            try:
                tup = q.get(timeout=0.05)
            except queue.Empty:
                continue
            t0 = time.perf_counter()
            try:
                if stream is None:
                    emissions = op.fn(tup.payload) or []
                else:
                    with torch.cuda.stream(stream):
                        emissions = op.fn(tup.payload) or []
                    stream.synchronize()
            except Exception as exc:  # drop the poison tuple, count the failure
                emissions = []
                with self._completed_lock:
                    self.failures[name] += 1
                    self.last_failure = exc
            service = time.perf_counter() - t0
            probe.on_processed(service)
            with self._roots_lock:  # _complete_one mutates the dict under it
                root = self._roots.get(tup.root_id)
            if root is not None:
                with root.lock:
                    root.outstanding += len(emissions)
            for dst, payload in emissions:
                self._enqueue(dst, StreamTuple(payload, tup.root_id, time.perf_counter()))
            self._complete_one(tup.root_id)

    def _complete_one(self, root_id: int) -> None:
        with self._roots_lock:
            root = self._roots.get(root_id)
        if root is None:
            return
        with root.lock:
            root.outstanding -= 1
            done = root.outstanding == 0
            shed = root.shed
        if done:
            with self._roots_lock:
                self._roots.pop(root_id, None)
            if shed:
                # Partially-processed tree: its sojourn would be biased low
                # (the shed branches never ran) — count it separately.
                with self._completed_lock:
                    self.shed_roots += 1
                return
            sojourn = time.perf_counter() - root.t_arrival
            self.measurer.on_tuple_complete(sojourn)
            with self._completed_lock:
                self.completed_sojourns.append(sojourn)

    # ------------------------------------------------------------------ #
    def start(self, allocation: dict[str, int]) -> None:
        self.scale_to(allocation)

    def drain(self, timeout: float = 10.0) -> bool:
        """Wait for all in-flight roots to complete."""
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            with self._roots_lock:
                if not self._roots:
                    return True
            time.sleep(0.01)
        return False

    def stop(self) -> None:
        self._stop.set()
        for workers in self._workers.values():
            for t in workers:
                t.join(timeout=1.0)
