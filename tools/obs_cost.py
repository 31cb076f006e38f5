"""What the serving path's spans and counters (``repro_torch.obs``) cost, and
how their device times split a call, for one benchmark cell on the card.

    python3 tools/obs_cost.py <cell> [--pairs N] [--seed S]

Sets the cell up as ``bench/run.py`` does (its configuration, seeded
weights, traffic and warm-up; a cell held in ``bench/held/`` too), then:

1. ``N`` pairs of calls, one with ``obs.recording()`` and one without, in
   turns (off-on, on-off, ...), no profiler and no routing record: each
   call's host ms (the entry point's call to its return) and wall ms (to
   its tokens on the host), and the recorded calls' span device times
   (root, ``layer.attn``, ``layer.ffn``, ``moe.experts``) with the share the
   layers' spans cover of the root;
2. the benchmark's traced segment (``bench/harness/cell._traced``): the
   block rooflines as the benchmark reads them, the same span sums, the
   SwiGLU kernels' device time, and the device's idle stretches by the host
   span or operator running when each began.

Prints one JSON line and writes it to ``chiprun_out/obs_cost_<cell>.json``.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import statistics
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPANS = ("layer.attn", "layer.ffn", "moe.experts")
METRICS = ("attn_block_roofline.prefill", "ffn_block_roofline.prefill",
           "expert_gemm_roofline.prefill")


def cell_of(name: str):
    """Cell ``name`` of BENCHMARK.json, or a held one."""
    from bench.harness.spec import BENCH_DIR, benchmark, load_cell, load_json

    bench = benchmark()
    if name not in {w["name"] for w in bench["workloads"]}:
        held = load_json(BENCH_DIR / "held" / f"{name}.json")
        bench = {**bench, "workloads": bench["workloads"] + [held["workload"]],
                 "end_to_end": bench["end_to_end"] + held["end_to_end"],
                 "per_layer": bench["per_layer"] + held["per_layer"]}
    return load_cell(name, bench=bench)


def split(recs: list) -> dict:
    """Device ms a call of each span name (mean over ``recs``) and the share
    of the root that the layers' spans cover; None without device times."""
    if any(s["device_ms"] is None for r in recs for s in r["spans"]):
        return None
    out = {}
    for name in ("root", *SPANS):
        out[name] = statistics.fmean(
            sum(s["device_ms"] for s in r["spans"]
                if (s["parent"] is None if name == "root" else s["name"] == name))
            for r in recs)
    out["covered"] = (out["layer.attn"] + out["layer.ffn"]) / out["root"]
    out["counters"] = recs[-1]["counters"]
    return out


def summary(calls: list) -> dict:
    host = [c["dispatch"] * 1e3 for c in calls]
    wall = [c["t"] * 1e3 for c in calls]
    return {"host_ms_median": statistics.median(host), "host_ms_mean": statistics.fmean(host),
            "wall_ms_median": statistics.median(wall), "wall_ms_mean": statistics.fmean(wall)}


def measure(spec, seed: int, pairs: int, dev) -> dict:
    """Both parts for cell ``spec`` on ``dev``."""
    import torch

    from bench.harness import cell as runner
    from bench.harness import program
    from bench.harness.spec import load_reader
    from bench.harness.weights import draw, stream_seed
    from repro_torch import obs

    if dev.type == "cuda":
        program.build_kernels()
    params = draw(spec.dims, seed, dev)
    cfg = program.model_config(spec.config)
    gen = torch.Generator(device=dev).manual_seed(stream_seed(seed, 1))
    kind = spec.traffic["kind"]
    drv = (runner.Prefill if kind == "prefill" else runner.Decode)(
        program.api(), params, cfg, spec.traffic, dev, gen, spec.dims.experts > 0)
    drv.record = False
    for _ in range(spec.traffic["warmup_calls"]):
        drv.call()
    with obs.recording():  # the recording path's first call
        drv.call()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    side = {False: [], True: []}
    for i in range(pairs):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            if on:
                with obs.recording():
                    side[on].append(drv.call())
            else:
                side[on].append(drv.call())
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    off, on = summary(side[False]), summary(side[True])
    out = {"cell": spec.name, "device": str(dev) if dev.type != "cuda" else
           torch.cuda.get_device_name(dev), "pairs": pairs,
           "off": off, "on": on,
           "on_less_off": {k: on[k] - off[k] for k in off},
           "recorded": split(obs.calls()[-pairs:])}

    n = spec.traffic["traced_calls"]
    calls, tl, launches = runner._traced(drv, n, dev.type == "cuda")
    for c in calls:
        c.pop("rec", None)
    run = runner.Run(cell=spec, traced=True, traced_calls=calls, timeline=tl, launches=launches)
    labels = collections.Counter()
    for s, e in tl.gaps():
        labels[tl.host_at(s + min(e - s, 2e-6))] += (e - s) * 1e3
    out["traced"] = {
        "metrics": {m: load_reader(m).read(run) for m in METRICS},
        "spans": split(obs.calls()[-n:]),
        "swiglu_kernels_ms_per_call": 1e3 * sum(e - s for _n, _c, s, e in tl.kernels("swiglu_"))
        / n,
        "window_ms": tl.window_s * 1e3, "busy_ms": tl.busy_s() * 1e3,
        "idle_ms_by_label": dict(labels.most_common()),
    }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cell")
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--seed", type=int, default=2**33 + 17)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    out = measure(cell_of(args.cell), args.seed, args.pairs, torch.device("cuda:0"))
    line = json.dumps(out)
    dest = ROOT / "chiprun_out" / f"obs_cost_{args.cell}.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
