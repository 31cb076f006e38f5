"""Training loop with checkpointed restarts (the port of
``repro/training/loop.py``).

* resume from checkpoint: parameters, optimizer state and the data
  iterator's step restore together (the step in the checkpoint's
  ``extra``), so a killed run resumes on the same synthetic stream; the
  checkpoint is the JAX store's layout, so a run resumes from a directory
  the JAX package's loop wrote.  The step saved is the stream position of
  the batches the loop consumed (the loader delivers the stream with no
  gap).  (The reference saves its source's step, which the loader's
  generate thread has already advanced past the prefetched batches, so its
  resumed run skips them; ROADMAP Queue 3.);
* async checkpoints every ``ckpt_every`` steps (``save_async`` copies every
  leaf to host memory before it returns, so the in-place update of the
  next step cannot reach the checkpoint);
* a step watchdog: a step longer than ``step_timeout_factor`` x the median
  records a :class:`StragglerEvent`;
* :class:`ElasticController` restarts from the latest checkpoint after a
  lease change.

The input pipeline is a :class:`~repro_torch.data.pipeline.PipelinedLoader`
with fixed workers, as the reference's loop builds it (its docstring says a
DRS scheduler rescales the workers; its code does not, ROADMAP Queue 1
item 8).  Tensors live on ``device`` (default: the CUDA device).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from ..checkpoint.store import CheckpointStore
from ..data.pipeline import DataConfig, PipelinedLoader, SyntheticTokens
from ..device import resolve_device
from ..models.common import ModelConfig
from .optimizer import AdamWConfig
from .train_step import TrainState, init_train_state, make_train_step, require_trained

__all__ = ["LoopConfig", "TrainLoop", "StragglerEvent", "ElasticController"]


@dataclass(frozen=True)
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_keep: int = 3
    log_every: int = 10
    step_timeout_factor: float = 5.0  # x median step time -> straggler event
    seed: int = 0


@dataclass
class StragglerEvent:
    step: int
    duration: float
    median: float


class TrainLoop:
    def __init__(
        self,
        cfg: ModelConfig,
        opt_cfg: AdamWConfig,
        loop_cfg: LoopConfig,
        *,
        ckpt_dir: str | Path,
        data_cfg: DataConfig | None = None,
        on_metrics: Callable[[int, dict], None] | None = None,
        device=None,
    ):
        require_trained(cfg)
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.loop_cfg = loop_cfg
        self.device = resolve_device(device)
        self.store = CheckpointStore(ckpt_dir)
        self.data_cfg = data_cfg or DataConfig(
            vocab=cfg.vocab, batch=2, seq_len=16, seed=loop_cfg.seed
        )
        self.on_metrics = on_metrics
        self.step_times: list[float] = []
        self.straggler_events: list[StragglerEvent] = []
        self.metrics_history: list[dict] = []
        self.loader_workers: dict[str, int] = {}

    # ------------------------------------------------------------------ #
    def _init_or_restore(self) -> tuple[TrainState, SyntheticTokens]:
        state = init_train_state(self.cfg, self.opt_cfg, self.loop_cfg.seed,
                                 device=self.device)
        source = SyntheticTokens(self.data_cfg)
        latest = self.store.latest_step()
        if latest is not None:
            state, extra = self.store.restore(state, latest)
            source.restore(extra["data"])
        return state, source

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, *, steps: int | None = None, crash_at: int | None = None) -> TrainState:
        """Run (or resume) training.  ``crash_at`` simulates a failure
        after that step's checkpoint-eligible point (for restart tests)."""
        lc = self.loop_cfg
        steps = steps if steps is not None else lc.total_steps
        state, source = self._init_or_restore()
        data_start = source.step  # the loader's thread prefetches past it
        loader = PipelinedLoader(source, workers={"generate": 1, "transform": 1})
        self.loader_workers = loader.k()
        step_fn = make_train_step(self.cfg, self.opt_cfg)
        try:
            start = int(state.step)
            for step in range(start, steps):
                t0 = time.perf_counter()
                batch = {k: torch.as_tensor(v, device=self.device).long()
                         for k, v in next(loader).items()}
                state, metrics = step_fn(state, batch)
                self._sync()
                dt = time.perf_counter() - t0
                self.step_times.append(dt)
                med = float(np.median(self.step_times[-50:]))
                if len(self.step_times) > 5 and dt > lc.step_timeout_factor * med:
                    self.straggler_events.append(StragglerEvent(step, dt, med))
                m = {k: float(v) for k, v in metrics.items()}
                m["step_time"] = dt
                self.metrics_history.append(m)
                if self.on_metrics and (step % lc.log_every == 0):
                    self.on_metrics(step, m)
                done = step + 1
                if done % lc.ckpt_every == 0 or done == steps:
                    self.store.save_async(
                        done, state,
                        extra={"data": {"step": data_start + done - start,
                                        "seed": self.data_cfg.seed}})
                if crash_at is not None and done >= crash_at:
                    self.store.wait()
                    raise RuntimeError(f"simulated crash at step {done}")
            self.store.wait()
            self.store.prune(lc.ckpt_keep)
            return state
        finally:
            loader.stop()


class ElasticController:
    """Reacts to lease changes: checkpoint -> rebuild -> resume (on one
    device the control flow: restore onto a fresh state and resume the data
    stream exactly)."""

    def __init__(self, loop: TrainLoop):
        self.loop = loop
        self.restarts: list[dict] = []

    def on_lease_change(self, change) -> None:
        self.restarts.append({"before": change.k_max_before, "after": change.k_max_after})

    def resume(self, *, steps: int) -> TrainState:
        """Restart from the latest checkpoint after a topology change."""
        return self.loop.run(steps=steps)
