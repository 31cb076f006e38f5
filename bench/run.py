"""The benchmark of the PyTorch / CUDA port: one run of one cell.

    python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  Sets up the
cell (kernels, seeded weights on the card, the traffic, warm-up), measures
for ``--seconds``, with ``--trace 1`` traces a short segment after the
window, checks the outputs against the float32 reference, and prints the
result as one JSON line, last on standard output; the numbers compared and
their limits are the last lines on standard error.  Exits non-zero, with no
result, without a CUDA device or with fewer than the cell asks for.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    base = ROOT / "build" / "bench-cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(base / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(base / "triton"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from bench.harness import cell as runner
    from bench.harness.spec import load_cell

    spec = load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        print(f"{args.workload} needs {spec.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line, run, _readings = runner.run(spec, args.seed, args.seconds, bool(args.trace), "cuda:0")
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(runner.FORBIDDEN))
    if loaded:
        print(f"modules loaded that the benchmark must not load: {loaded}", file=sys.stderr)
        return 3
    print("phases " + " ".join(f"{k} {v:.3f}" for k, v in run.phases.items())
          + f" calls {len(run.calls)} window_s {run.window_s:.3f}", file=sys.stderr)
    for name, (value, limit) in line["check"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
