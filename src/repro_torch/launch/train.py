"""Training driver of the port: a llama-family model through the
checkpointed :class:`~repro_torch.training.loop.TrainLoop` (async
checkpoints, straggler log, crash and resume) on the card, or on the CPU
with ``--device cpu``.  ``--preset full`` trains the published width and
depth and needs the card; on the card ``--preset smoke`` runs at the
attention kernels' head dim (``configs.for_kernels``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
      --preset smoke --steps 200 --ckpt build/train_ckpt --device cpu
"""

from __future__ import annotations

import argparse
import json

from ..configs import ARCHS, for_kernels, get_config
from ..data.pipeline import DataConfig
from ..training.loop import LoopConfig, TrainLoop
from ..training.optimizer import AdamWConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCHS, default="llama3.2-1b")
    ap.add_argument("--preset", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default="build/train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--crash-at", type=int, default=None,
                    help="simulate a failure after this step (restart demo)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.preset == "full" and args.device == "cpu":
        raise SystemExit("--preset full trains at the published size and needs the card")
    cfg = get_config(args.arch, args.preset)
    if args.device != "cpu":
        cfg = for_kernels(cfg)
    loop = TrainLoop(
        cfg,
        AdamWConfig(lr=args.lr, warmup_steps=10, decay_steps=args.steps),
        LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every, log_every=10),
        ckpt_dir=args.ckpt,
        data_cfg=DataConfig(vocab=cfg.vocab, batch=args.batch, seq_len=args.seq_len),
        on_metrics=lambda step, m: print(
            f"step {step:5d} loss {m['loss']:.4f} lr {m['lr']:.2e} "
            f"gnorm {m['grad_norm']:.2f} {m['step_time']*1e3:.0f} ms"
        ),
        device=args.device,
    )
    try:
        loop.run(crash_at=args.crash_at)
    except RuntimeError as e:
        print(f"!! {e}: run again to resume from the latest checkpoint")
        raise SystemExit(1) from None
    summary = {
        "final_loss": loop.metrics_history[-1]["loss"] if loop.metrics_history else None,
        "steps": len(loop.metrics_history),
        "stragglers": len(loop.straggler_events),
        "checkpoints": loop.store.latest_step(),
        "loader_workers": loop.loader_workers,
        "device": args.device,
    }
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
