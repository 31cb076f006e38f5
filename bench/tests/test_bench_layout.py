"""The benchmark's files: ``BENCHMARK.json`` within the contract's limits,
every part found by name, a new cell or metric picked up as new files, the
result's line, and no JAX or JAX package among the harness's modules."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest

from bench.harness import cell as runner
from bench.harness.spec import BENCH_DIR, ROOT, load_cell, load_reader, metrics_for

from ._tiny import CELLS, cell, tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert BENCH["paths"] == ["bench"] and BENCH["command"] == ["python3", "bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_text():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for entry in BENCH["configs"] + BENCH["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for entry in BENCH["workloads"]:
        assert NAME.match(entry["config"]) and NAME.match(entry["traffic"])
        assert entry["chips"] in (1, 4)
    for entry in metrics:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
    for entry in BENCH["configs"]:
        assert all(NAME.match(k) for k in entry["reduced"]) and len(entry["reduced"]) <= 16
    texts = [e["why"] for e in BENCH["configs"] + BENCH["workloads"]]
    texts += [e["layer"] for e in BENCH["per_layer"]] + [e["source"] for e in BENCH["configs"]]
    for t in texts + BENCH["command"]:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t
    names = [e["name"] for e in metrics]
    assert len(names) == len(set(names))


def test_bounds_and_moves():
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= e["bound"] <= 0.25 for e in e2e.values())
    assert all(e["source"] in ("host_clock", "device_trace") for e in e2e.values())
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for c in m["workloads"]:
            assert c in cells
            assert c in e2e[m["moves"]].get("workloads", [c])
    for c in cells:  # setup_s, one other end-to-end metric and one per-layer metric
        assert len(metrics_for(BENCH["end_to_end"], c)) >= 2
        assert metrics_for(BENCH["per_layer"], c)


@pytest.mark.parametrize("name", CELLS)
def test_cell_parts_found_by_name(name):
    c = cell(name)
    assert c.config["name"] == c.config_name
    assert c.traffic["kind"] in ("prefill", "decode")
    for entry in c.end_to_end + c.per_layer:
        assert callable(load_reader(entry["name"]).read)


def test_new_cell_and_metric_are_new_files(tmp_path):
    """A cell and a per-layer metric added as files and entries, no file
    edited: the harness finds them."""
    shutil.copytree(BENCH_DIR, tmp_path / BENCH_DIR.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = tmp_path / BENCH_DIR.name
    (base / "traffic" / "prefill-2x1024.json").write_text(json.dumps(
        {**json.loads((base / "traffic" / "prefill-4x4096.json").read_text()),
         "batch": 2, "prompt_len": 1024, "cache_rows": 1024}))
    (base / "workloads" / "phi3-prefill-2x1024.json").write_text('{"limits": {}}')
    (base / "metrics" / "prompt_tokens.prefill.py").write_text(
        "def read(run):\n    return sum(c['tokens'] for c in run.calls)\n")
    bench["workloads"].append({"name": "phi3-prefill-2x1024", "config": "phi3-medium-14b",
                               "traffic": "prefill-2x1024", "chips": 1, "why": "short"})
    bench["end_to_end"][0]["workloads"].append("phi3-prefill-2x1024")
    bench["per_layer"].append({"name": "prompt_tokens.prefill", "unit": "tokens",
                               "better": "higher", "source": "program_counter",
                               "layer": "device", "moves": "prefill_tokens_per_s",
                               "workloads": ["phi3-prefill-2x1024"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = load_cell("phi3-prefill-2x1024", tmp_path)
    assert c.traffic["prompt_len"] == 1024 and c.config_name == "phi3-medium-14b"
    assert [m["name"] for m in c.per_layer] == ["prompt_tokens.prefill"]
    assert load_reader("prompt_tokens.prefill", tmp_path).read(
        runner.Run(cell=c, traced=True, calls=[{"tokens": 5}])) == 5


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(traced):
    line, run, _ = runner.run(tiny("mixtral-decode-16x2048"), 2**40 + 3, 0.1, traced, "cpu",
                              steps=4)
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += ["breakdown", "check"] if traced else ["check"]
    assert list(line) == want  # the numbers compared come last
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if traced:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    names = {m["name"] for m in (run.cell.per_layer if traced else run.cell.end_to_end)}
    assert set(line["metrics"]) <= names
    json.dumps(line)


def test_no_jax_or_repro_module_is_loaded():
    """The harness's imports, the port's serving path, the profiler: no
    module whose top-level name is jax, jaxlib, flax or repro (the part
    before the first dot compared whole: repro_torch is allowed)."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import torch.profiler\n"
        "from bench.harness import cell, check, control, program, readers, trace\n"
        "import bench.run, bench.calibrate, bench.reference.model\n"
        "program.api(); program.model_config(cell.load_cell_for_test())\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'repro'}), 'repro_torch' in tops)\n"
    ) % (str(ROOT / "src"), str(ROOT))
    code = code.replace("cell.load_cell_for_test()",
                        "__import__('bench.harness.spec', fromlist=['x'])"
                        ".load_cell('phi3-prefill-4x4096').config")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[0] == "[] True"


def test_run_refuses_without_a_card(tmp_path):
    out = subprocess.run([sys.executable, str(BENCH_DIR / "run.py"), "--workload",
                          "phi3-prefill-4x4096", "--seed", str(2**33), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=120,
                         cwd=ROOT, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                                        "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("recorded", [2, 1, 3])
def test_roofline_needs_every_launch_recorded(recorded):
    """A kernel's roofline reads its device time only where the trace holds
    one record for each launch that the program counted."""
    import collections

    from bench.harness import trace

    c = cell("phi3-prefill-4x4096")
    ops = [("flash_wgmma_kernel", "kernel", 0.1 * i, 0.1 * i + 0.05) for i in range(recorded)]
    run = runner.Run(cell=c, traced=True, traced_calls=[{"b": 4, "s": 4096}],
                     timeline=trace.Timeline(window_s=1.0, ops=ops),
                     launches=collections.Counter(flash_attention=2))
    value = load_reader("flash_roofline.prefill").read(run)
    assert (value is not None) == (recorded == 2)
