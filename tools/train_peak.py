#!/usr/bin/env python3
"""Peak device memory and step time of one model's training step (or, with
``--serve``, its serving path) at full width and several depths, on one
CUDA card: the reading that sets how far ``chip_smoke.py``'s ``train``
and ``moe_serve`` phases cut a model that one card cannot hold whole.

    python3 tools/train_peak.py zamba2-7b 18 24 30    # arch, then depths
    python3 tools/train_peak.py mixtral-8x22b 1 2     # training
    python3 tools/train_peak.py mixtral-8x22b 12 13 --serve --batch 2 --seq 8192

Each depth, training: the seeded state (bf16 parameters, float32 moments)
and ``make_train_step`` under ``torch.use_deterministic_algorithms`` (as
``chip_smoke.py`` trains) on ``train_4k``'s sequence of 4096 with the batch
cut to 2 (as ``chip_smoke.TRAIN_B`` / ``TRAIN_S``), ``--steps`` steps
(default 2).  ``--serve``: bf16 parameters, a prefill of ``--batch`` x
``--seq`` tokens into a cache 32 longer and ``--steps`` decode steps.
``--experts`` cuts a MoE's expert count.  One JSON line per depth:
parameters, shared-block sites, peak allocated GB
(``torch.cuda.max_memory_allocated``), the last step's (or the prefill's
and the last decode step's) ms, or the out-of-memory error.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models.transformer import shared_sites
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import init_train_state, make_train_step

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("arch")
    ap.add_argument("layers", type=int, nargs="+")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--serve", action="store_true", help="prefill and decode, no training")
    ap.add_argument("--experts", type=int, default=None, help="a MoE's expert count")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_peak: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    opt = AdamWConfig(lr=3e-4, warmup_steps=2, decay_steps=8)
    if not args.serve:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    for n in args.layers:
        cfg = dataclasses.replace(get_config(args.arch, "full"), n_layers=n)
        if args.experts:
            cfg = dataclasses.replace(cfg, n_experts=args.experts)
        row = {"arch": args.arch, "layers": n, "params": cfg.params_count(),
               "sites": len(shared_sites(cfg)) if cfg.family == "hybrid" else 0,
               "batch": args.batch, "seq": args.seq,
               "card": torch.cuda.get_device_name(0)}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if args.serve:
            print(json.dumps({**row, **serve_peak(cfg, args, dev)}), flush=True)
            continue
        try:
            state = init_train_state(cfg, opt, 0, device=dev)
            step = make_train_step(cfg, opt)
            source = SyntheticTokens(DataConfig(vocab=cfg.vocab, batch=args.batch,
                                                seq_len=args.seq))
            for _ in range(args.steps):
                batch = {k: torch.as_tensor(v, device=dev).long() for k, v in next(source).items()}
                t0 = time.perf_counter()
                state, m = step(state, batch)
                torch.cuda.synchronize()
                row["step_ms"] = (time.perf_counter() - t0) * 1e3
            row["loss"] = float(m["loss"])
            row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        except torch.cuda.OutOfMemoryError as exc:
            row["error"] = str(exc).splitlines()[0]
            row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        state = step = None
        print(json.dumps(row), flush=True)
    return 0


def serve_peak(cfg, args, dev) -> dict:
    """Peak memory of ``cfg``'s prefill of ``args.batch`` x ``args.seq``
    tokens and ``args.steps`` decode steps, bf16 parameters from seed 0."""
    import torch

    from repro_torch.models import serve
    from repro_torch.models.transformer import init_params

    row = {"mode": "serve"}
    try:
        params = init_params(cfg, seed=0, device=dev)
        tokens = torch.randint(0, cfg.vocab, (args.batch, args.seq), device=dev)
        cache = serve.init_cache(cfg, args.batch, args.seq + 32, device=dev)
        t0 = time.perf_counter()
        logits, cache = serve.prefill(params, cfg, {"tokens": tokens}, cache, device=dev)
        torch.cuda.synchronize()
        row["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        for _ in range(args.steps):
            t0 = time.perf_counter()
            logits, cache = serve.decode_step(params, cfg, logits.argmax(-1), cache, device=dev)
            torch.cuda.synchronize()
            row["step_ms"] = (time.perf_counter() - t0) * 1e3
    except torch.cuda.OutOfMemoryError as exc:
        row["error"] = str(exc).splitlines()[0]
    row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    params = cache = logits = None
    return row


if __name__ == "__main__":
    sys.exit(main())
