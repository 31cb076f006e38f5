"""One run of one cell: set-up, the measured window, the traced segment
(with ``--trace 1``), the check, and the result's line.

The system under test is the port's serving path
(``repro_torch.models.serve``: ``init_cache``, ``prefill``,
``decode_step``), looked up on its module at each call.  Two traffic kinds,
both a closed loop of one client:

``prefill``  back-to-back calls, each over ``batch`` fresh prompts of
             ``prompt_len`` seeded tokens, from an empty cache (``prefill``
             writes rows 0..S-1 and sets the length); the first token of
             each prompt is read back to the host.  The check judges the
             window's last call: its logits and the cache it leaves.  The
             window's calls record nothing; for a mixture of experts the
             traced segment's calls record their routing (``step_mfu``
             counts the kept pairs), and the check takes the judged call's
             routing from the same prompts run again after the window.
``decode``   ``batch`` sessions, their prompts prefilled at set-up in
             groups of ``prefill_group``; the window then decodes all of
             them together, greedily, each step's tokens read back to the
             host and fed to the next step.  When the cache is full the
             sessions start their continuations again from the prompt.
             Every step records its routing (the check follows it over
             every step since the last restart), so this kind is held out
             of ``BENCHMARK.json`` until a program counter replaces that
             record (``held/``).
"""

from __future__ import annotations

import collections
import os
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import check, program, trace
from .spec import Cell, capacity_factor, load_reader
from .weights import draw, stream_seed
from .yardstick import bound_s, decode_step_work, prefill_work

#: Top-level modules the process that prints a result may not hold (``run.py``
#: looks once the window has closed).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SPAN = torch.profiler.record_function


@dataclass
class Run:
    """What a run measured; the metric readers read it."""

    cell: Cell
    traced: bool
    setup_s: float = 0.0
    window_s: float = 0.0
    calls: list = field(default_factory=list)  # the window's calls or steps
    traced_calls: list = field(default_factory=list)  # the traced segment's
    timeline: trace.Timeline | None = None
    launches: collections.Counter = field(default_factory=collections.Counter)
    phases: dict = field(default_factory=dict)  # host seconds of set-up's steps and the check
    sample: dict = field(default_factory=dict)  # the traffic the check compared

    @property
    def kind(self) -> str:
        return self.cell.traffic["kind"]

    @property
    def dims(self):
        return self.cell.dims


def _rec(routing) -> list | None:
    return [] if routing else None


def _moe_counts(rec: list) -> tuple[int, int]:
    """(kept pairs, experts that received one), summed over the layers."""
    kept = experts = 0
    for layer in rec:
        ex, kp = layer["experts"], layer["kept"].to(torch.bool)
        kept += int(kp.sum())
        experts += int(torch.unique(ex[kp]).numel())
    return kept, experts


class Prefill:
    def __init__(self, api, params, cfg, traffic: dict, device, gen, moe: bool):
        self.api, self.params, self.cfg, self.dev, self.moe = api, params, cfg, device, moe
        self.shape, self.gen = (traffic["batch"], traffic["prompt_len"]), gen
        self.rows = traffic["cache_rows"]
        self.cache = api.init_cache(cfg, self.shape[0], self.rows, device=device)
        self.last = None
        self.record = False  # record the calls' routing (mixture of experts)

    def call(self) -> dict:
        tokens = torch.randint(0, self.cfg.vocab, self.shape, generator=self.gen, device=self.dev)
        rec = _rec(self.moe and self.record)
        t0 = time.perf_counter()
        with SPAN("bench.prefill"):
            logits, cache = self.api.prefill(self.params, self.cfg, {"tokens": tokens}, self.cache,
                                             device=self.dev, routing=rec)
        t1 = time.perf_counter()
        with SPAN("bench.read_tokens"):
            logits.argmax(-1).cpu()
        t2 = time.perf_counter()
        self.cache = cache
        self.last = (tokens, logits)
        return {"t": t2 - t0, "dispatch": t1 - t0, "tokens": tokens.numel(),
                "b": tokens.shape[0], "s": tokens.shape[1], "rec": rec}

    def replay(self, tokens) -> tuple[list, torch.Tensor]:
        """(the routing, the logits) of the same call over ``tokens`` again,
        from an empty cache of its own, recording its routing."""
        rec = []
        cache = self.api.init_cache(self.cfg, tokens.shape[0], self.rows, device=self.dev)
        logits, _ = self.api.prefill(self.params, self.cfg, {"tokens": tokens}, cache,
                                     device=self.dev, routing=rec)
        return rec, logits


class Decode:
    def __init__(self, api, params, cfg, traffic: dict, device, gen, moe: bool):
        self.api, self.params, self.cfg, self.dev, self.moe = api, params, cfg, device, moe
        b, self.p, self.s_max = traffic["batch"], traffic["prompt_len"], traffic["cache_rows"]
        self.prompts = torch.randint(0, cfg.vocab, (b, self.p), generator=gen, device=device)
        self.cache = api.init_cache(cfg, b, self.s_max, device=device)
        self.record = True  # the check follows every step's routing
        self.prefill_records = []
        self.all_records = []  # every step's routing
        firsts = []
        g = traffic["prefill_group"]
        for b0 in range(0, b, g):
            view = {"k": self.cache["k"][:, b0:b0 + g], "v": self.cache["v"][:, b0:b0 + g],
                    "length": self.cache["length"]}
            rec = _rec(moe)
            logits, out = api.prefill(params, cfg, {"tokens": self.prompts[b0:b0 + g]}, view,
                                      device=device, routing=rec)
            firsts.append(logits.argmax(-1))
            if moe:
                self.prefill_records.append(rec)
        self.length = out["length"]
        self.first = torch.cat(firsts)
        self.first_host = self.first.cpu()
        self.restart()

    def restart(self):
        """Start every session's continuation from its prompt's end."""
        self.cache = {**self.cache, "length": self.length.clone()}
        self.tok = self.first
        self.inputs = [self.first_host]  # the tokens the steps take in
        self.outputs = []  # the tokens they give out
        self.records = []  # the steps' routing since the restart

    def call(self) -> dict:
        if self.p + len(self.outputs) >= self.s_max:
            self.restart()
        rec = _rec(self.moe and self.record)
        keys = self.p + len(self.outputs) + 1
        t0 = time.perf_counter()
        with SPAN("bench.decode_step"):
            logits, self.cache = self.api.decode_step(self.params, self.cfg, self.tok, self.cache,
                                                      device=self.dev, routing=rec)
        t1 = time.perf_counter()
        with SPAN("bench.read_tokens"):
            self.tok = logits.argmax(-1)
            host = self.tok.cpu()
        t2 = time.perf_counter()
        self.outputs.append(host)
        self.inputs.append(host)
        if self.moe:
            self.records.append(rec)
            self.all_records.append(rec)
        return {"t": t2 - t0, "dispatch": t1 - t0, "tokens": host.numel(), "b": host.numel(),
                "keys": keys, "rec": rec}


def process_age_s() -> float:
    """Seconds since this process started (Linux: its start in clock ticks
    since boot against the uptime)."""
    with open("/proc/self/stat") as fh:
        start = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        up = float(fh.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def _work(run: Run, c: dict) -> tuple[int, int]:
    m = run.dims
    kept, experts = c.get("moe", (None, None))
    if run.kind == "prefill":
        return prefill_work(m, c["b"], c["s"], kept)
    return decode_step_work(m, c["b"], c["keys"], kept, experts)


def bound_total(run: Run, calls: list) -> float:
    """The least time the card could take for ``calls``."""
    return sum(bound_s(*_work(run, c)) for c in calls)


def _traced(drv, n: int, on_cuda: bool):
    """(the calls, their timeline, the program's launch counts) of ``n``
    calls under the profiler; a session that lost kernel records is made
    again, up to three times."""
    from repro_torch.kernels import _build

    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    drv.record = True
    for attempt in range(3):
        calls = []
        before = collections.Counter(_build.LAUNCHES)
        with torch.profiler.profile(activities=acts) as prof:
            with SPAN(trace.SEGMENT):
                for _ in range(n):
                    calls.append(drv.call())
                if on_cuda:
                    torch.cuda.synchronize()
        launches = collections.Counter(_build.LAUNCHES) - before
        tl = trace.read(prof)
        if not on_cuda or (tl.ops and not tl.dropped):
            break
        print(f"trace: attempt {attempt + 1} recorded {len(tl.ops)} device operations, "
              f"{tl.dropped} launches without their kernel", file=sys.stderr)
    return calls, tl, launches


def run(cell: Cell, seed: int, seconds: float, traced: bool, device, *, steps: int | None = None,
        api=None) -> tuple[dict, Run, dict]:
    """One run -> (the result's line as a dict, the run, the program's
    outputs kept for the check).  ``steps``: a fixed number of calls in
    place of the window's seconds (calibration)."""
    dev = torch.device(device)
    on_cuda = dev.type == "cuda"
    api = api or program.api()
    cfg = program.model_config(cell.config)
    moe = cell.dims.experts > 0
    phases = {}
    t = time.perf_counter()
    if on_cuda:
        program.build_kernels()
    phases["kernels_s"], t = time.perf_counter() - t, time.perf_counter()
    params = draw(cell.dims, seed, dev)
    _sync(dev)
    phases["weights_s"], t = time.perf_counter() - t, time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(stream_seed(seed, 1))
    kind = cell.traffic["kind"]
    drv = (Prefill if kind == "prefill" else Decode)(api, params, cfg, cell.traffic, dev, gen, moe)
    _sync(dev)
    phases["traffic_s"], t = time.perf_counter() - t, time.perf_counter()
    for _ in range(cell.traffic["warmup_calls"]):
        drv.call()
    if kind == "decode":
        drv.all_records = []
        drv.restart()
    _sync(dev)
    phases["warmup_s"] = time.perf_counter() - t
    r = Run(cell=cell, traced=traced, phases=phases)
    r.setup_s = process_age_s()
    w0 = time.perf_counter()
    while True:
        r.calls.append(drv.call())
        elapsed = time.perf_counter() - w0
        if (len(r.calls) >= steps) if steps else elapsed >= seconds:
            break
    r.window_s = elapsed
    if traced:
        r.traced_calls, r.timeline, r.launches = _traced(drv, cell.traffic["traced_calls"],
                                                         on_cuda)
    peak = torch.cuda.max_memory_allocated(dev) if on_cuda else 0
    return _result(r, drv, params, seed, peak, dev)


def _result(r: Run, drv, params, seed, peak, dev):
    cell = r.cell
    moe = cell.dims.experts > 0
    for c in r.calls + r.traced_calls:
        rec = c.pop("rec")
        if moe and rec is not None:
            c["moe"] = _moe_counts(rec)
    metrics = {}
    for entry in (cell.per_layer if r.traced else cell.end_to_end):
        value = load_reader(entry["name"]).read(r)
        if value is not None:
            metrics[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    t = time.perf_counter()
    readings, r.sample = judge(r, drv, params, seed, dev)
    r.phases["check_s"] = time.perf_counter() - t
    r.sample["params"] = params
    ok, table = check.verdict(readings, cell.check.get("limits", {}))
    attempted = sum(c["tokens"] if r.kind == "decode" else c["b"] for c in r.calls)
    line = {"correct": ok, "attempted": attempted, "failed": 0, "metrics": metrics,
            "device": device_info(dev, peak, r)}
    if r.traced and r.timeline is not None:
        line["breakdown"] = r.timeline.breakdown()
    line["check"] = table
    return line, r, readings


def device_info(dev, peak: int, r: Run) -> dict:
    if dev.type != "cuda":
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
                "memory_peak_bytes": int(peak)}
    if r.traced and r.timeline is not None:
        info["busy_s"] = r.timeline.busy_s()
        info["window_s"] = r.timeline.window_s
    return info


def judge(r: Run, drv, params, seed, dev) -> tuple[dict, dict]:
    """(the check's readings, the traffic they compared): the program's
    outputs against the reference, run once the program's state is freed."""
    cell = r.cell
    shape = program.reference_shape(cell.config)
    cf = capacity_factor(cell.config) if cell.dims.experts else 0.0
    if r.kind == "prefill":
        tokens, logits = drv.last
        k, v = drv.cache["k"], drv.cache["v"]
        s = tokens.shape[1]
        experts, sample = None, {"tokens": tokens}
        if cell.dims.experts:
            rec, again = drv.replay(tokens)
            sample["replay_equal"] = bool(torch.equal(again, logits))
            del again
            experts = [(layer["experts"].reshape(*tokens.shape, -1),
                        layer["kept"].reshape(*tokens.shape, -1)) for layer in rec]
        drv.cache = None
        _free(dev)
        out = check.judge_prefill(params, shape, tokens, logits.float(),
                                  lambda i: (k[i, :, :s], v[i, :, :s]), experts)
        if cell.dims.experts:
            out["kept_wrong"] = check.kept_wrong([rec], cell.dims.experts, cf)
        return out, sample
    n = cell.check["sessions"]
    rng = np.random.default_rng(stream_seed(seed, 2))
    b = drv.prompts.shape[0]
    pick = torch.as_tensor(np.sort(rng.choice(b, size=min(n, b), replace=False)), device=dev)
    steps = len(drv.outputs)
    p = drv.p
    ins = torch.stack(drv.inputs[:steps], dim=1).to(dev)[pick]  # [n, N]
    served = torch.stack(drv.outputs, dim=1).to(dev)[pick]
    seqs = torch.cat([drv.prompts[pick], ins], dim=1)
    k = drv.cache["k"][:, pick, p:p + steps].clone()
    v = drv.cache["v"][:, pick, p:p + steps].clone()
    experts = None
    if cell.dims.experts:
        experts = []
        g = cell.traffic["prefill_group"]
        for layer in range(cell.dims.layers):
            pre_e, pre_k = [], []
            for idx in pick.tolist():
                rec = drv.prefill_records[idx // g][layer]
                rows = slice((idx % g) * p, (idx % g + 1) * p)
                pre_e.append(rec["experts"][rows])
                pre_k.append(rec["kept"][rows])
            step_e = torch.stack([s_[layer]["experts"][pick] for s_ in drv.records], dim=1)
            step_k = torch.stack([s_[layer]["kept"][pick] for s_ in drv.records], dim=1)
            experts.append((torch.cat([torch.stack(pre_e), step_e], dim=1),
                            torch.cat([torch.stack(pre_k), step_k], dim=1)))
    records = drv.prefill_records + drv.all_records
    drv.cache = None
    _free(dev)
    out = check.judge_decode(params, shape, seqs, served, p, lambda i: (k[i], v[i]), experts)
    if cell.dims.experts:
        out["kept_wrong"] = check.kept_wrong(records, cell.dims.experts, cf)
    sample = {"seqs": seqs, "p": p, "pick": pick, "prompts": drv.prompts,
              "inputs": torch.stack(drv.inputs[:steps], dim=1).to(dev)}
    return out, sample


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _free(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()

