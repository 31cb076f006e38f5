"""The serving path's spans and counters (``repro_torch.obs``) on the CPU, at
the dense and moe smoke configs: nothing recorded and ``record_function``
never entered with recording off; under a profiler session one root a call
with a ``layer.attn`` and a ``layer.ffn`` span a layer (``moe.experts``
under the FFN), the same spans in the exported Chrome trace inside the
root's interval; outputs bit for bit those with recording off; the kept
pair counter equal to the routing record's; the records bounded."""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import pathlib
import sys

import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.models import serve, transformer

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench.harness.cell import _moe_counts  # noqa: E402

ARCHS = ("llama3.2-1b", "mixtral-8x22b")
ENTRIES = ("prefill", "decode_step")
B, S = 2, 12


@pytest.fixture
def records(monkeypatch):
    """A fresh record store for the test."""
    fresh = collections.deque(maxlen=obs.KEEP)
    monkeypatch.setattr(obs, "_RECORDS", fresh)
    return fresh


def _model(arch: str, **changes):
    cfg = dataclasses.replace(get_config(arch, "smoke"), **changes)
    return cfg, transformer.init_params(cfg, 3, device="cpu")


def _tokens(cfg, shape, seed: int = 5):
    return torch.randint(0, cfg.vocab, shape, generator=torch.Generator().manual_seed(seed))


def _serve(entry: str, cfg, params, routing=None, record: bool = False):
    """(logits, cache) of one prefill, or of one decode step after a
    prefill; ``record``: the prefill or the step under ``obs.recording()``,
    ``routing`` its routing."""
    cache = serve.init_cache(cfg, B, S + 2, device="cpu")
    tokens = _tokens(cfg, (B, S))
    scope = obs.recording() if record else contextlib.nullcontext()
    if entry == "prefill":
        with scope:
            return serve.prefill(params, cfg, {"tokens": tokens}, cache, device="cpu",
                                 routing=routing)
    logits, cache = serve.prefill(params, cfg, {"tokens": tokens}, cache, device="cpu")
    with scope:
        return serve.decode_step(params, cfg, logits.argmax(-1), cache, device="cpu",
                                 routing=routing)


@pytest.mark.parametrize("arch", ARCHS)
def test_off_records_nothing_and_enters_no_record_function(arch, records, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with recording off")

    monkeypatch.setattr(obs, "record_function", refuse)
    assert not obs.enabled()
    cfg, params = _model(arch)
    for entry in ENTRIES:
        _serve(entry, cfg, params)
    transformer.forward(params, cfg, {"tokens": _tokens(cfg, (B, S))})
    assert len(records) == 0 and obs.calls() == []


def _check_tree(rec: dict, root: str, cfg) -> None:
    spans = rec["spans"]
    assert rec["name"] == root and spans[0]["name"] == root and spans[0]["parent"] is None
    assert [s["name"] for s in spans].count(root) == 1
    for name in ("layer.attn", "layer.ffn"):
        mine = [s for s in spans if s["name"] == name]
        assert [s["layer"] for s in mine] == list(range(cfg.n_layers))
        assert all(s["parent"] == 0 for s in mine)
    experts = [s for s in spans if s["name"] == "moe.experts"]
    assert len(experts) == (cfg.n_layers if cfg.n_experts else 0)
    assert all(spans[s["parent"]]["name"] == "layer.ffn" for s in experts)
    for s in spans:
        assert s["device_ms"] is None  # no events on the CPU
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] is not None:
            p = spans[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] and s["end_ns"] <= p["end_ns"]


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_profiler_session_records_the_span_tree(arch, entry, records, tmp_path):
    cfg, params = _model(arch)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        assert obs.enabled()
        if entry == "prefill":
            _serve(entry, cfg, params)
        else:  # the prefill ahead of the step records too, under a profiler
            cache = serve.init_cache(cfg, B, S + 2, device="cpu")
            logits, cache = serve.prefill(params, cfg, {"tokens": _tokens(cfg, (B, S))}, cache,
                                          device="cpu")
            serve.decode_step(params, cfg, logits.argmax(-1), cache, device="cpu")
    root = f"serve.{entry}"
    recs = obs.calls()
    assert [r["name"] for r in recs] == (["serve.prefill"] if entry == "prefill"
                                         else ["serve.prefill", "serve.decode_step"])
    rec = recs[-1]
    _check_tree(rec, root, cfg)

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    ann = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    roots = [e for e in ann if e["name"] == root]
    assert len(roots) == 1
    t0, t1 = roots[0]["ts"], roots[0]["ts"] + roots[0]["dur"]
    inside = collections.Counter(e["name"] for e in ann
                                 if t0 <= e["ts"] and e["ts"] + e["dur"] <= t1)
    want = collections.Counter(s["name"] for s in rec["spans"])
    assert inside == want


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_recording_changes_no_output(arch, entry, records):
    cfg, params = _model(arch)
    off_logits, off_cache = _serve(entry, cfg, params)
    on_logits, on_cache = _serve(entry, cfg, params, record=True)
    assert len(records) == 1
    assert torch.equal(on_logits, off_logits)
    assert set(on_cache) == set(off_cache)
    for key in off_cache:
        assert torch.equal(on_cache[key], off_cache[key]), key


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("capacity", [0.5, 1.25])
def test_kept_pairs_counter_equals_the_routing_record(entry, capacity, records):
    cfg, params = _model("mixtral-8x22b", capacity_factor=capacity)
    routing = []
    _serve(entry, cfg, params, routing=routing, record=True)
    (rec,) = obs.calls()
    t = B * (S if entry == "prefill" else 1)
    kept = _moe_counts(routing)[0]
    assert rec["counters"] == {"moe.pairs_kept": kept,
                               "moe.pairs_routed": t * cfg.top_k * cfg.n_layers}
    if capacity == 0.5:  # a drop regime: the counter is not the routed count
        assert kept < t * cfg.top_k * cfg.n_layers


def test_records_are_bounded(records):
    with obs.recording():
        for i in range(obs.KEEP + 5):
            with obs.call(f"call{i}", "cpu"):
                obs.count("n", i)
    got = obs.calls()
    assert len(got) == obs.KEEP
    assert [r["name"] for r in got] == [f"call{i}" for i in range(5, obs.KEEP + 5)]
    assert got[-1]["counters"] == {"n": obs.KEEP + 4}


def test_spans_outside_a_call_and_nested_calls(records):
    """Training's forward records nothing; a call opened inside a call is a
    span of the outer one."""
    cfg, params = _model("mixtral-8x22b")
    with obs.recording():
        transformer.forward(params, cfg, {"tokens": _tokens(cfg, (B, S))})
        obs.count("moe.pairs_kept", 3)
        assert obs.calls() == []
        with obs.call("outer", "cpu"):
            with obs.call("inner", "cpu"):
                with obs.span("leaf"):
                    pass
    (rec,) = obs.calls()
    assert [(s["name"], s["parent"]) for s in rec["spans"]] == [("outer", None), ("inner", 0),
                                                                ("leaf", 1)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the slot counters record the card's products")
    return torch.device("cuda")


def test_slot_counters_on_the_card(cuda_device, records):
    """mixtral's smoke model at the kernels' head dim in bf16 on the card,
    2 x 64 prompt tokens: the prefill's experts (512 slots an expert, ~64
    filled) take the grouped kernels, so ``moe.slots_run`` is each
    expert's filled slots from the routing record rounded up to the 128-row
    tile and cut at the capacity; the decode step's 8 slots take
    ``torch.bmm``, every slot run.  On the CPU the record keeps the pair
    counters alone (the test above)."""
    from repro_torch.configs import for_kernels
    from repro_torch.kernels.moe_experts import MIN_SLOTS, run_rows
    from repro_torch.models.ffn import moe_capacity

    cfg = dataclasses.replace(for_kernels(get_config("mixtral-8x22b", "smoke")),
                              dtype=torch.bfloat16)
    params = transformer.init_params(cfg, 3, device=cuda_device)
    s = 64
    cache = serve.init_cache(cfg, B, s + 2, device=cuda_device)
    tokens = _tokens(cfg, (B, s)).to(cuda_device)
    pre, step = [], []
    with obs.recording():
        logits, cache = serve.prefill(params, cfg, {"tokens": tokens}, cache,
                                      device=cuda_device, routing=pre)
        serve.decode_step(params, cfg, logits.argmax(-1), cache, device=cuda_device,
                          routing=step)
        torch.cuda.synchronize()
    got = [r["counters"] for r in obs.calls()]
    for counters, routing, t in ((got[0], pre, B * s), (got[1], step, B)):
        cap = moe_capacity(cfg, t)
        slots = cfg.n_experts * cap * cfg.n_layers
        run = 0
        for layer in routing:
            n = torch.bincount(layer["experts"].reshape(-1).cpu(), minlength=cfg.n_experts)
            run += (int(run_rows(n.clamp(max=cap), cap).sum()) if cap >= MIN_SLOTS
                    else cfg.n_experts * cap)
        assert counters["moe.slots"] == slots and counters["moe.slots_run"] == run
    assert got[0]["moe.slots_run"] < got[0]["moe.slots"]
    assert got[1]["moe.slots_run"] == got[1]["moe.slots"]
