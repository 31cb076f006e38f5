"""End-to-end training on the port: a small llama for a few hundred steps
with async checkpoints, a simulated crash and an exact resume, on the card
(the attention and the FFN run their CUDA kernels forward, autograd of
their plain versions backward; the smoke config widened to the kernels'
head dim, 64) or with ``--device cpu``.

Kill the run mid-flight, start it again, watch it resume from the
checkpoint on the same synthetic token stream (keyed by (seed, step)).

    PYTHONPATH=src python examples/train_smoke_torch.py              # on the card
    PYTHONPATH=src python examples/train_smoke_torch.py --device cpu
"""

import argparse
import shutil
import tempfile
from pathlib import Path

from repro_torch.configs import for_kernels, get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.training.loop import LoopConfig, TrainLoop
from repro_torch.training.optimizer import AdamWConfig

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
ap.add_argument("--steps", type=int, default=300)
args = ap.parse_args()

ckpt_dir = Path(tempfile.mkdtemp(prefix="repro_torch_train_"))
cfg = get_config("llama3.2-1b", "smoke")
if args.device != "cpu":
    cfg = for_kernels(cfg)
STEPS = args.steps
CRASH = STEPS // 2


def make_loop():
    return TrainLoop(
        cfg,
        AdamWConfig(lr=3e-3, warmup_steps=20, decay_steps=STEPS),
        LoopConfig(total_steps=STEPS, ckpt_every=CRASH // 3 or 1, log_every=25),
        ckpt_dir=ckpt_dir,
        data_cfg=DataConfig(vocab=cfg.vocab, batch=4, seq_len=32),
        on_metrics=lambda s, m: print(
            f"  step {s:4d}  loss {m['loss']:.4f}  ({m['step_time']*1e3:.0f} ms)"
        ),
        device=args.device,
    )


print(f"[1] training {cfg.arch} on {args.device} for {STEPS} steps: simulated crash at "
      f"{CRASH}")
try:
    make_loop().run(crash_at=CRASH)
except RuntimeError as e:
    print(f"    crashed as planned: {e}")

print(f"[2] restarting: resumes from the step-{CRASH} checkpoint")
loop = make_loop()
state = loop.run()
print(f"[3] done: final loss {loop.metrics_history[-1]['loss']:.4f} "
      f"(resumed from step {CRASH}, finished at {int(state.step)})")
first = loop.metrics_history[0]["loss"]
last = loop.metrics_history[-1]["loss"]
print(f"    loss {first:.3f} -> {last:.3f} over the resumed segment")
shutil.rmtree(ckpt_dir, ignore_errors=True)
