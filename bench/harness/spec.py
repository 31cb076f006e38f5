"""Finding a cell's parts by name.

``BENCHMARK.json`` (at the checkout's root) names each cell's configuration
and traffic; their files are ``configs/<config>.json`` and
``traffic/<traffic>.json`` under the benchmark's folder, the cell's own
check settings ``workloads/<cell>.json``, and each metric's reader
``metrics/<metric>.py``.  A cell, a configuration, a traffic mix or a metric
is added as new files and a new entry in ``BENCHMARK.json``, with no edit to
any file here.  ``held/<cell>.json`` keeps a cell that the harness runs
but ``BENCHMARK.json`` does not name yet, with the entries that would name
it.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
from dataclasses import dataclass, field

from .yardstick import Dims

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    """One cell: its entry, its configuration and traffic files' contents,
    its check settings and the metrics it reports."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    check: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    @property
    def dims(self) -> Dims:
        return dims_of(self.config)


def load_json(path: pathlib.Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def metrics_for(entries: list, cell: str) -> list:
    """The metric entries that a cell reports: those that list it under
    ``workloads`` and those with no such list."""
    return [m for m in entries if cell in m.get("workloads", [cell])]


def load_cell(name: str, root: pathlib.Path = ROOT, bench: dict | None = None) -> Cell:
    """Cell ``name`` of ``bench`` (default: the checkout's ``BENCHMARK.json``)."""
    bench = bench or benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    bench_dir = root / BENCH_DIR.name
    return Cell(
        name=name, chips=int(w["chips"]),
        config_name=w["config"], config=load_json(root / configs[w["config"]]["file"]),
        traffic_name=w["traffic"],
        traffic=load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        check=load_json(bench_dir / "workloads" / f"{name}.json"),
        end_to_end=metrics_for(bench["end_to_end"], name),
        per_layer=metrics_for(bench["per_layer"], name),
    )


def dims_of(config: dict) -> Dims:
    """The yardstick's sizes from a configuration in its source's keys
    (``sliding_window`` as Hugging Face masks it: a query sees the keys
    ``j > i - sliding_window``, itself included)."""
    d, hq = config["hidden_size"], config["num_attention_heads"]
    return Dims(layers=config["num_hidden_layers"], d=d, hq=hq,
                hkv=config["num_key_value_heads"], dh=config.get("head_dim") or d // hq,
                f=config["intermediate_size"], vocab=config["vocab_size"],
                experts=config.get("num_local_experts", 0),
                top_k=config.get("num_experts_per_tok", 0),
                window=config.get("sliding_window"))


def capacity_factor(config: dict) -> float:
    """The MoE layers' slots per expert as a multiple of an even share (a
    run setting the configuration file states under ``run``)."""
    return float(config["run"]["capacity_factor"])


def load_reader(name: str, root: pathlib.Path = ROOT):
    """The reader module of metric ``name``: ``metrics/<name>.py``, whose
    ``read(run)`` returns the metric's value or None when the run has
    nothing for it to read."""
    path = root / BENCH_DIR.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
