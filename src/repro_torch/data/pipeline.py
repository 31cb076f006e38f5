"""Host-side data pipeline of the training loop (the port of
``repro/data/pipeline.py``, numpy and threads, no torch).

The pipeline is a chain of host operators -- generate -> transform ->
ready queue -- each with its own pool of worker threads, the paper's
operator / processor structure: :meth:`PipelinedLoader.scale_stage` is the
knob a DRS scheduler turns, and an optional ``measurer`` samples each
stage.  The training loop builds the loader with fixed workers, as the
reference's loop does (ROADMAP: the loop does not wire a scheduler yet).

The synthetic token source is deterministic given (seed, step), the same
stream as the reference's, so a run restored from a checkpoint replays the
exact stream: the iterator's state is its step counter, which the loop's
checkpoint keeps in ``extra``.

A stage whose output queue stays full keeps the batch it holds and offers
it again.  (The reference's stages drop it after a 0.2 s / 5 s timeout and
draw the next, so the stream a slow consumer receives has gaps that depend
on timing; ROADMAP Queue 3.)  The stream this loader delivers is the
source's, in order, with one worker per stage.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np

__all__ = ["DataConfig", "SyntheticTokens", "PipelinedLoader"]


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    pack_docs: bool = True
    mean_doc_len: int = 512


class SyntheticTokens:
    """Deterministic synthetic LM stream: doc-packed token blocks.

    Documents have exponential lengths (mean ``mean_doc_len``), contents
    are a Zipf-ish unigram draw, and documents are packed back-to-back
    into (batch, seq_len) blocks with EOS=0 separators — shaped like a
    real pretraining feed, cheap enough for CPU smoke runs.
    """

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self.step = start_step

    def _block(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b, s = cfg.batch, cfg.seq_len
        total = b * (s + 1)
        if cfg.pack_docs:
            toks = np.empty(total, dtype=np.int64)
            pos = 0
            while pos < total:
                doc_len = max(1, int(rng.exponential(cfg.mean_doc_len)))
                n = min(doc_len, total - pos - 1)
                # Zipf-ish unigram over the vocab
                u = rng.random(n)
                toks[pos : pos + n] = (cfg.vocab - 2) * u**3 + 1
                pos += n
                if pos < total:
                    toks[pos] = 0  # EOS
                    pos += 1
        else:
            toks = rng.integers(1, cfg.vocab, size=total)
        toks = toks.reshape(b, s + 1).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        out = self._block(self.step)
        self.step += 1
        return out

    def state(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    def restore(self, state: dict) -> None:
        assert state["seed"] == self.cfg.seed, "seed mismatch on restore"
        self.step = int(state["step"])


class PipelinedLoader:
    """Multi-stage prefetching loader with per-stage worker pools.

    Stages: generate -> transform (tokenize/augment hook) -> ready queue.
    Per-stage parallelism is adjustable at runtime (`scale_stage`), which
    is the knob the DRS scheduler turns.
    """

    def __init__(
        self,
        source: SyntheticTokens,
        *,
        transform=None,
        capacity: int = 8,
        workers: dict[str, int] | None = None,
        measurer=None,
    ):
        self.source = source
        self.transform = transform or (lambda x: x)
        self._raw: queue.Queue = queue.Queue(maxsize=capacity)
        self._ready: queue.Queue = queue.Queue(maxsize=capacity)
        self._stop = threading.Event()
        self._source_lock = threading.Lock()
        self.measurer = measurer
        self._probes = {}
        if measurer is not None:
            self._probes = {
                "generate": measurer.new_probe("generate"),
                "transform": measurer.new_probe("transform"),
            }
        self._workers: dict[str, list[tuple[threading.Thread, threading.Event]]] = {
            "generate": [],
            "transform": [],
        }
        workers = workers or {"generate": 1, "transform": 1}
        for stage, n in workers.items():
            self.scale_stage(stage, n)

    def scale_stage(self, stage: str, n: int) -> None:
        cur = self._workers[stage]
        while len(cur) < n:
            ev = threading.Event()
            t = threading.Thread(target=self._loop, args=(stage, ev), daemon=True)
            cur.append((t, ev))
            t.start()
        while len(cur) > n:
            _, ev = cur.pop()
            ev.set()

    def k(self) -> dict[str, int]:
        return {s: len(w) for s, w in self._workers.items()}

    def _put(self, q: queue.Queue, item, timeout: float) -> bool:
        """Offer ``item`` until ``q`` takes it or the loader stops (a worker
        that is scaled away still hands on the batch it holds)."""
        while not self._stop.is_set():
            try:
                q.put(item, timeout=timeout)
                return True
            except queue.Full:
                continue
        return False

    def _loop(self, stage: str, stop: threading.Event) -> None:
        import time as _time

        while not stop.is_set() and not self._stop.is_set():
            if stage == "generate":
                with self._source_lock:
                    item = next(self.source)
                t0 = _time.perf_counter()
                if not self._put(self._raw, item, 0.2):
                    return
                if self._probes:
                    self._probes["generate"].on_enqueue()
                    self._probes["generate"].on_processed(_time.perf_counter() - t0)
            else:
                try:
                    item = self._raw.get(timeout=0.2)
                except queue.Empty:
                    continue
                t0 = _time.perf_counter()
                out = self.transform(item)
                if not self._put(self._ready, out, 5.0):
                    return
                if self._probes:
                    self._probes["transform"].on_enqueue()
                    self._probes["transform"].on_processed(_time.perf_counter() - t0)

    def __next__(self):
        while True:
            try:
                return self._ready.get(timeout=5.0)
            except queue.Empty:
                if self._stop.is_set():
                    raise StopIteration from None

    def __iter__(self):
        return self

    def stop(self) -> None:
        self._stop.set()
        for stage in self._workers.values():
            for _, ev in stage:
                ev.set()
