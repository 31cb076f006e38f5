"""The block rooflines that read the program's spans and counters
(``bench/harness/spans.py``, ``blocks.py`` and their three readers): the
counts at the two prefill cells' shapes against values worked by hand, the
shares on synthetic records, and None (never 0) wherever the records are
missing, too few, of another kind or without device times."""

from __future__ import annotations

import sys

import pytest

from bench.harness import cell as runner
from bench.harness.blocks import attn_block_work, expert_gemm_work, ffn_block_work
from bench.harness.spec import load_reader
from bench.harness.yardstick import PEAK_FLOPS_BF16, Dims

from ._tiny import cell, tiny

PHI3 = Dims(layers=40, d=5120, hq=40, hkv=10, dh=128, f=17920, vocab=32064, window=2047)
MIXTRAL = Dims(layers=13, d=6144, hq=48, hkv=8, dh=128, f=16384, vocab=32768, experts=8,
               top_k=2)
KEPT = 364_000  # of 13 x 16,384 x 2 = 425,984 routed pairs
NAMES = ("attn_block_roofline.prefill", "ffn_block_roofline.prefill",
         "expert_gemm_roofline.prefill")


def test_attn_block_work_at_the_cells():
    # phi3 a layer: 2 x 5120 (2 x 40 x 128 + 2 x 10 x 128) = 131,072,000 a token x 16,384
    # = 2,147,483,648,000, plus flash in the window 515,312,107,520; x 40 layers.
    # bytes 2 (5120 x 12,800 + 5120 + 2 x 16,384 x 5120) = 466,626,560 a layer
    assert attn_block_work(PHI3, 4, 4096) == (18_665_062_400, 106_511_830_220_800)
    # mixtral: 176,160,768 a token x 16,384 = 2,886,218,022,912, flash over every causal
    # pair 824,835,047,424; x 13 layers
    assert attn_block_work(MIXTRAL, 4, 4096) == (7_524_741_120, 48_243_689_914_368)


def test_ffn_and_expert_work_at_the_cells():
    # phi3: 40 x (swiglu's 886,046,720 bytes + the norm's 10,240), 40 x 9,019,431,321,600
    assert ffn_block_work(PHI3, 16384) == (35_442_278_400, 360_777_252_864_000)
    # mixtral: router 13 x 2 x 16,384 x 6144 x 8 = 20,937,965,568; experts
    # 6 x 6144 x 16,384 x 364,000 = 219,848,638,464,000
    experts = 219_848_638_464_000
    # every expert 2 x 3 x 6144 x 16,384 = 603,979,776 bytes, x 8 x 13 = 62,813,896,704;
    # plus 13 x 2 (6144 x 8 + 6144 + 2 x 16,384 x 6144)
    assert ffn_block_work(MIXTRAL, 16384, KEPT) == (68_049_825_792, 20_937_965_568 + experts)
    assert expert_gemm_work(MIXTRAL, KEPT) == (62_813_896_704, experts)


def _record(root: str, layers: int, ms: dict, counters: dict | None = None) -> dict:
    """A call's record as ``repro_torch.obs.calls`` gives it: ``ms[name]`` a
    span's device ms, one span of each name a layer (``moe.experts`` under
    ``layer.ffn``)."""
    spans = [{"name": root, "layer": 0, "parent": None, "start_ns": 0, "end_ns": 1,
              "device_ms": sum(ms.values()) * layers}]
    for i in range(layers):
        for name in ("layer.attn", "layer.ffn", "moe.experts"):
            if name in ms:
                parent = len(spans) - 1 if name == "moe.experts" else 0
                spans.append({"name": name, "layer": i, "parent": parent, "start_ns": 0,
                              "end_ns": 1, "device_ms": ms[name]})
    return {"name": root, "spans": spans, "counters": counters or {}}


def _run(name: str, records: list, monkeypatch, calls: int = 2):
    from repro_torch import obs

    monkeypatch.setattr(obs, "calls", lambda: list(records))
    return runner.Run(cell=cell(name), traced=True,
                      traced_calls=[{"b": 4, "s": 4096, "tokens": 16384}] * calls)


def _read(name: str, run):
    return load_reader(name).read(run)


def test_phi3_block_shares(monkeypatch):
    # 5 ms a layer's attention, 9 ms its FFN: 200 and 360 ms a call
    recs = [_record("serve.prefill", 40, {"layer.attn": 5.0, "layer.ffn": 9.0})] * 2
    run = _run("phi3-prefill-4x4096", recs, monkeypatch)
    attn = 100 * 106_511_830_220_800 / PEAK_FLOPS_BF16 / 0.2
    ffn = 100 * 360_777_252_864_000 / PEAK_FLOPS_BF16 / 0.36
    assert _read(NAMES[0], run) == pytest.approx(attn, rel=1e-12)  # 53.85 %
    assert _read(NAMES[1], run) == pytest.approx(ffn, rel=1e-12)  # 101.3 %: the bound binds
    assert _read(NAMES[2], run) is None  # no experts


def test_mixtral_block_shares(monkeypatch):
    counters = {"moe.pairs_kept": KEPT, "moe.pairs_routed": 425_984}
    ms = {"layer.attn": 6.0, "layer.ffn": 40.0, "moe.experts": 34.0}
    recs = [_record("serve.prefill", 13, ms, counters)] * 2
    run = _run("mixtral-prefill-4x4096", recs, monkeypatch)
    experts = 219_848_638_464_000
    assert _read(NAMES[0], run) == pytest.approx(
        100 * 48_243_689_914_368 / PEAK_FLOPS_BF16 / 0.078, rel=1e-12)
    assert _read(NAMES[1], run) == pytest.approx(
        100 * (20_937_965_568 + experts) / PEAK_FLOPS_BF16 / 0.52, rel=1e-12)
    assert _read(NAMES[2], run) == pytest.approx(100 * experts / PEAK_FLOPS_BF16 / 0.442,
                                                 rel=1e-12)  # 50.3 %


def test_each_call_reads_its_own_kept_pairs(monkeypatch):
    ms = {"layer.attn": 6.0, "layer.ffn": 40.0, "moe.experts": 34.0}
    recs = [_record("serve.prefill", 13, ms, {"moe.pairs_kept": kept, "moe.pairs_routed":
                                              425_984}) for kept in (300_000, 400_000)]
    run = _run("mixtral-prefill-4x4096", recs, monkeypatch)
    flops = 6 * 6144 * 16384 * 700_000
    assert _read(NAMES[2], run) == pytest.approx(100 * flops / PEAK_FLOPS_BF16 / 0.884,
                                                 rel=1e-12)


@pytest.mark.parametrize("case", ["no records", "fewer", "no device time", "another root",
                                  "routed differs", "no such span", "decode run"])
def test_none_where_there_is_nothing_to_read(case, monkeypatch):
    counters = {"moe.pairs_kept": KEPT, "moe.pairs_routed": 425_984}
    ms = {"layer.attn": 6.0, "layer.ffn": 40.0, "moe.experts": 34.0}
    rec = _record("serve.prefill", 13, ms, counters)
    recs = [rec, rec]
    if case == "no records":
        recs = []
    elif case == "fewer":
        recs = [rec]
    elif case == "no device time":  # as on the CPU
        recs = [rec, {**rec, "spans": [{**s, "device_ms": None} for s in rec["spans"]]}]
    elif case == "another root":
        recs = [rec, {**rec, "name": "serve.decode_step"}]
    elif case == "routed differs":
        recs = [rec, {**rec, "counters": {**counters, "moe.pairs_routed": 425_983}}]
    elif case == "no such span":
        recs = [rec, {**rec, "spans": [s for s in rec["spans"] if s["name"] != "moe.experts"]}]
    run = _run("mixtral-prefill-4x4096", recs, monkeypatch)
    if case == "decode run":
        run.cell = cell("mixtral-decode-16x2048")
    got = [_read(n, run) for n in NAMES]
    if case in ("routed differs", "no such span"):
        assert got[2] is None and got[0] is not None  # only the blocks that need it
    else:
        assert got == [None, None, None]


def test_none_without_the_program_module(monkeypatch):
    """A program that records nothing (no ``repro_torch.obs``)."""
    run = runner.Run(cell=cell("phi3-prefill-4x4096"), traced=True,
                     traced_calls=[{"b": 4, "s": 4096}] * 2)
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    assert [_read(n, run) for n in NAMES] == [None, None, None]


def test_cpu_run_records_the_traced_calls_and_reports_no_share():
    """The harness on the CPU: the traced segment's calls are the last
    records, with the counters the routing records agree with, and no span
    has a device time, so no share is reported."""
    from repro_torch import obs

    c = tiny("mixtral-prefill-4x4096")
    line, run, _ = runner.run(c, 2**40 + 7, 0.1, True, "cpu", steps=3)
    recs = obs.calls()[-len(run.traced_calls):]
    m = run.dims
    for call, rec in zip(run.traced_calls, recs):
        assert rec["name"] == "serve.prefill"
        names = [s["name"] for s in rec["spans"]]
        assert names.count("layer.attn") == names.count("moe.experts") == m.layers
        assert rec["counters"] == {"moe.pairs_kept": call["moe"][0],
                                   "moe.pairs_routed": m.layers * call["b"] * call["s"] * 2}
        assert all(s["device_ms"] is None for s in rec["spans"])
    assert not set(line["metrics"]) & set(NAMES)
