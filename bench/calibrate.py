"""The readings that a cell's limits are set from, and the proof that they
separate: the program's check numbers over many seeds, the control's (the
float8 reference in the program's place) over some of them, and the
planted faults' (``bench/harness/faults.py``), in one process, each with
its verdict under the cell's committed limits.

    python bench/calibrate.py --workload <cell> --seeds 11 12 ... --steps <n>
        [--control 11 12 13] [--faults <seed>]

``--steps``: the calls (prefill) or steps (decode) each seed runs after its
warm-up, as many as a run's check needs (a prefill run judges its last call;
a decode run every step since the sessions' last restart).  ``--faults``:
the seed at which each planted fault runs.  Prints one JSON line a reading;
writes nothing.  Not run by the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--steps", type=int, required=True)
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--faults", type=int, default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from bench.harness import cell as runner, check, control, faults
    from bench.harness.spec import load_cell

    spec = load_cell(args.workload, ROOT)
    limits = spec.check.get("limits", {})
    dev = "cuda:0" if torch.cuda.is_available() else "cpu"

    def emit(out):
        print(json.dumps(out), flush=True)
        if dev != "cpu":
            torch.cuda.empty_cache()

    for seed in args.seeds:
        t0 = time.perf_counter()
        line, run, readings = runner.run(spec, seed, 0.0, False, dev, steps=args.steps)
        out = {"seed": seed, "steps": len(run.calls), "program": readings,
               "program_ok": line["correct"], "program_s": time.perf_counter() - t0,
               "metrics": line["metrics"]}
        if "replay_equal" in run.sample:
            out["replay_equal"] = run.sample["replay_equal"]
        if seed in args.control:
            t1 = time.perf_counter()
            got = control.readings(spec, run.sample["params"], run.sample)
            if spec.dims.experts:  # the control routes itself by the capacity rule
                got["kept_wrong"] = 0
            out["control"] = got
            out["control_ok"] = check.verdict(got, limits)[0]
            out["control_s"] = time.perf_counter() - t1
        del line, run
        emit(out)
    if args.faults is not None:
        for fault in faults.FAULTS:
            line, run, readings = runner.run(spec, args.faults, 0.0, False, dev,
                                             steps=args.steps, api=faults.Api(fault))
            emit({"seed": args.faults, "fault": fault, "readings": readings,
                  "correct": line["correct"]})
            del line, run
    return 0


if __name__ == "__main__":
    sys.exit(main())
