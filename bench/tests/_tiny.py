"""A cell at a size the CPU runs in a second: its configuration's widths and
its traffic's lengths cut down, everything else as the cell has it."""

from __future__ import annotations

import copy
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from bench.harness.spec import BENCH_DIR, benchmark, load_cell, load_json  # noqa: E402

#: The cells of BENCHMARK.json, and the held decode cell, whose path the
#: harness keeps running.
CELLS = ("phi3-prefill-4x4096", "mixtral-prefill-4x4096", "mixtral-decode-16x2048")
HELD = ("mixtral-decode-16x2048",)


def with_held(bench: dict) -> dict:
    """``bench`` with the held cells' entries (``held/<cell>.json``) added."""
    bench = {**bench, **{k: list(bench[k]) for k in ("workloads", "end_to_end", "per_layer")}}
    for path in sorted((BENCH_DIR / "held").glob("*.json")):
        held = load_json(path)
        bench["workloads"].append(held["workload"])
        bench["end_to_end"] += held["end_to_end"]
        bench["per_layer"] += held["per_layer"]
    return bench


def cell(name: str):
    """A cell of BENCHMARK.json or a held one, at its own size."""
    return load_cell(name, bench=with_held(benchmark()) if name in HELD else None)


def tiny(name: str):
    c = copy.deepcopy(cell(name))
    c.config.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
                    num_hidden_layers=2, intermediate_size=128, vocab_size=256)
    if "num_local_experts" in c.config:
        c.config.update(num_local_experts=4)
    if c.config.get("sliding_window"):  # a window shorter than the prompts
        c.config.update(sliding_window=11)
    if c.traffic["kind"] == "prefill":
        c.traffic.update(batch=2, prompt_len=32, cache_rows=32)
    else:
        c.traffic.update(batch=4, prompt_len=16, cache_rows=24, prefill_group=2)
        c.check["sessions"] = 4
    return c
