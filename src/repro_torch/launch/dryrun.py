"""Dry-run: cost every (arch x shape x mesh) cell of the port on the host
(the port of ``repro/launch/dryrun.py``).

For each cell it

  1. builds the parameters, optimizer state, cache and batch as
     ``device="meta"`` tensors at the cell's global shapes (no allocation:
     kimi-k2 has 1T parameters) and resolves each leaf's spec from the rule
     tables (``distributed/sharding.py``);
  2. runs the port's own ``prefill``, ``decode_step`` or train step on them
     inside :class:`~repro_torch.launch.trace_cost.CostTrace`, which costs
     every operation per device (the kernels through their meta faces; a
     train step's layers rematerialised as the port trains them, so the
     trace sees their forward twice and their activations only while a
     layer's backward runs);
  3. writes a record in the reference's format -- ``status``, ``chips``,
     ``memory_analysis``, ``roofline`` (``launch/hlo_analysis.py``, on the
     H100's rates) and ``hlo_model`` -- plus ``hw``, the card and the link
     rate its collective term uses, to
     ``build/dryrun/{arch}--{shape}--{mesh}[-tag].json``, where
     ``serving/pipeline.py:rates_from_dryrun`` (and the serving launcher)
     read it.

``memory_analysis`` is per device: ``argument_size_in_bytes`` (the
parameters, in training with the moments and the two step counters, the
batch and the cache -- of a prefill only its self-attention k / v, whose
rows past the prompt it keeps), ``output_size_in_bytes`` (the outputs' shards and 8
bytes per output for the table of their buffers, as XLA counts a tuple),
``alias_size_in_bytes`` (the cache or state leaves the step writes in
place and returns) and ``temp_size_in_bytes`` (the trace's peak live bytes
less the arguments).  No JAX, no XLA flags and no card: host code only.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--force]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

from ..configs import ARCHS, get_config
from ..configs.shapes import SHAPES, cell_inputs, cell_is_supported, skip_reason
from ..distributed import sharding as shd
from ..models import serve
from ..models.common import ModelConfig
from ..models.transformer import param_axes, param_shapes
from ..training.optimizer import AdamWConfig, adamw_init
from ..training.train_step import TrainState, make_train_step
from .hlo_analysis import CollectiveStats, model_flops_for, roofline_terms
from .mesh import HW, make_production_mesh, mesh_name
from .trace_cost import CostTrace

__all__ = ["RESULTS_DIR", "STEP_LAYOUT", "step_cost", "run_cell", "save_record", "main"]

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"

#: Bytes XLA counts per output buffer for the tuple that holds them.
TUPLE_ENTRY_BYTES = 8

#: Cache leaves the step lays out otherwise than its arguments, by family:
#: the logical axes the trace gives them (their argument bytes keep the
#: declared spec).  XLA's partitioner carries rwkv6's token shifts split
#: over the tensor-parallel axis along ``d_model``, as the WKV heads are,
#: and gathers each shifted mix whole before its projection (the
#: reference's rwkv6 prefill and decode records: six ``all-gather``s of
#: [B, S, D] per layer).
STEP_LAYOUT = {"ssm": {"tm_shift": ("layers", "batch", "heads"),
                       "cm_shift": ("layers", "batch", "heads")}}


def _items(tree, prefix=""):
    """(dotted name, leaf) of a nested dict / tuple tree, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, f"{prefix}{k}.")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _items(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _spec_leaves(specs: dict):
    """The specs of a nested dict of specs, in order."""
    for v in specs.values():
        if isinstance(v, dict):
            yield from _spec_leaves(v)
        else:
            yield v


def meta_params(cfg: ModelConfig) -> dict:
    """The parameters as meta tensors of ``cfg.dtype`` (``init_params``
    draws with a generator, which has no meta form)."""
    def make(tree):
        return {k: make(v) if isinstance(v, dict) else
                torch.empty(v[0], dtype=cfg.dtype, device="meta") for k, v in tree.items()}

    return make(param_shapes(cfg))


def step_cost(cfg: ModelConfig, kind: str, global_batch: int, seq_len: int, mesh, rules: dict,
              *, moment_dtype=torch.float32, cache_rows: int | None = None):
    """Cost one step of ``kind`` (train, prefill or decode: a decode step
    reads its whole cache) of ``cfg`` on ``mesh`` under ``rules`` (pruned
    to the mesh); the cache holds ``cache_rows`` rows (default
    ``seq_len``).  Returns (``memory_analysis``, the trace's
    :class:`~repro_torch.launch.trace_cost.TraceCost`)."""
    rules = shd.prune_rules(rules, mesh)
    batch = cell_inputs(cfg, kind, global_batch, seq_len)
    b_specs = {k: shd.batch_spec(k, tuple(v.shape), rules, mesh) for k, v in batch.items()}
    # The batch axes are those the batch takes: at batch 1 (long_500k) it
    # takes none, and a parameter dim on "data" is split as any other.
    trace = CostTrace(mesh, {"batch": b_specs["tokens"][0]})
    arg_bytes = 0

    def register(tree, specs, kind_, logical=None, prefix="", counted=None, layout=None):
        nonlocal arg_bytes
        for key, t in tree.items():
            spec = specs[key] if specs is not None else ()
            lg = logical[key] if logical is not None else None
            if isinstance(t, dict):
                register(t, spec, kind_, lg, f"{prefix}{key}.")
                continue
            in_step = (shd.safe_spec(tuple(t.shape), layout[key], rules, mesh)
                       if layout and key in layout else spec)
            trace.register(t, in_step, kind_, prefix + key, lg)
            if counted is None or key in counted:
                arg_bytes += shd.shard_bytes(t.shape, t.dtype, spec, mesh)

    params = meta_params(cfg)
    axes = param_axes(cfg)
    p_specs = shd.tree_specs(params, axes, mesh, rules)
    register(params, p_specs, "param", axes)
    register(batch, b_specs, "input")
    if kind == "train":
        opt_cfg = AdamWConfig(moment_dtype=moment_dtype)
        opt = adamw_init(params, opt_cfg)
        state = TrainState(params, opt, torch.zeros((), dtype=torch.int32, device="meta"))
        register({"mu": opt.mu, "nu": opt.nu}, {"mu": p_specs, "nu": p_specs}, "state")
        register({"opt_step": opt.step, "step": state.step}, None, "state")
        inputs = [t for _n, t in _items((params, opt.mu, opt.nu, opt.step, state.step))]
        with trace:
            new_state, metrics = make_train_step(cfg, opt_cfg)(state, batch)
        leaf_specs = list(_spec_leaves(p_specs))
        outputs = [(t, s) for tree in (new_state.params, new_state.opt.mu, new_state.opt.nu)
                   for (_n, t), s in zip(_items(tree), leaf_specs)]
        outputs += [(new_state.opt.step, ()), (new_state.step, ())]
        outputs += [(t, ()) for _n, t in _items(metrics)]
    else:
        cache = serve.init_cache(cfg, global_batch, cache_rows or seq_len, device="meta")
        # A prefill keeps the self-attention k / v rows past the prompt and
        # recomputes every other cache leaf (states, shifts, cross k / v,
        # the length): only k / v are its inputs, as in the reference.
        register(cache, shd.cache_specs(cache, cfg.family, mesh, rules), "cache",
                 counted=("k", "v") if kind == "prefill" else None,
                 layout=STEP_LAYOUT.get(cfg.family))
        inputs = list(cache.values())
        with trace, torch.no_grad():
            if kind == "prefill":
                logits, new_cache = serve.prefill(params, cfg, batch, cache, device="meta")
            else:
                logits, new_cache = serve.decode_step(params, cfg, batch["tokens"], cache,
                                                      device="meta")
        c_specs = shd.cache_specs(new_cache, cfg.family, mesh, rules)
        outputs = [(logits, shd.safe_spec(tuple(logits.shape), ("batch", "vocab"), rules,
                                          mesh))]
        outputs += [(t, c_specs[k]) for k, t in new_cache.items()]
    trace.parameter_collectives(train=kind == "train")
    out_bytes = [shd.shard_bytes(t.shape, t.dtype, spec, mesh) for t, spec in outputs]
    mem = {
        "argument_size_in_bytes": arg_bytes,
        "output_size_in_bytes": sum(out_bytes) + TUPLE_ENTRY_BYTES * len(outputs),
        "temp_size_in_bytes": max(0, round(trace.cost.peak_bytes) - arg_bytes),
        "alias_size_in_bytes": sum(b for (t, _s), b in zip(outputs, out_bytes)
                                   if any(t is i for i in inputs)),
    }
    return mem, trace.cost


def run_cell(arch: str, shape: str, *, multi_pod: bool = False,
             rules_overrides: dict | None = None, cfg_overrides: dict | None = None,
             opt_moment_dtype=None, tag: str = "") -> dict:
    """Cost one cell; returns its record (:func:`save_record` writes it).
    Train cells keep their moments in ``opt_moment_dtype``, by default
    bf16 for kimi-k2 and float32 otherwise, as the reference does."""
    cfg = get_config(arch, "full")
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    spec = SHAPES[shape]
    mesh = make_production_mesh(multi_pod=multi_pod)
    name = mesh_name(multi_pod)
    link, link_bw = HW.link(mesh)
    record: dict = {"arch": arch, "shape": shape, "mesh": name, "chips": mesh.size, "tag": tag,
                    "time": time.strftime("%Y-%m-%d %H:%M:%S"),
                    "hw": {"name": HW.NAME, "peak_flops_bf16": HW.PEAK_FLOPS_BF16,
                           "hbm_bw": HW.HBM_BW, "hbm_bytes": HW.HBM_BYTES, "link": link,
                           "link_bw": link_bw}}
    if not cell_is_supported(arch, shape):
        record["status"] = "skipped"
        record["reason"] = skip_reason(arch, shape)
        return record
    rules = shd.rules_for(spec.kind, rules_overrides, arch=arch)
    moments = opt_moment_dtype or (torch.bfloat16 if arch == "kimi-k2-1t-a32b"
                                   else torch.float32)
    t0 = time.perf_counter()
    try:
        mem, cost = step_cost(cfg, spec.kind, spec.global_batch, spec.seq_len, mesh, rules,
                              moment_dtype=moments)
        record["trace_s"] = time.perf_counter() - t0
        coll = CollectiveStats(bytes_by_kind=dict(cost.bytes_by_kind),
                               count_by_kind=dict(cost.count_by_kind))
        terms = roofline_terms(arch=arch, shape=shape, mesh_name=name, chips=mesh.size,
                               cost={"flops": cost.flops, "bytes accessed": cost.traffic_bytes},
                               coll=coll, model_flops=model_flops_for(cfg, spec),
                               memory_analysis=mem, link_bw=link_bw)
        record["status"] = "ok"
        record["memory_analysis"] = mem
        record["roofline"] = terms.as_dict()
        record["hlo_model"] = {
            "flops": cost.flops, "traffic_bytes": cost.traffic_bytes,
            "collective_bytes": cost.collective_bytes, "dot_count": cost.dot_count,
            "kernel_calls": dict(cost.kernel_calls),
            "traffic_by_kind": {k: float(v) for k, v in sorted(
                cost.traffic_by_kind.items(), key=lambda kv: -kv[1])},
        }
    except Exception as e:  # noqa: BLE001 -- record and move on
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    return record


def record_path(arch: str, shape: str, mesh: str, tag: str = "", out_dir=None) -> Path:
    """``{arch}--{shape}--{mesh}[-tag].json`` in ``out_dir`` (default
    :data:`RESULTS_DIR`)."""
    out_dir = RESULTS_DIR if out_dir is None else Path(out_dir)
    return out_dir / f"{arch}--{shape}--{mesh}{f'-{tag}' if tag else ''}.json"


def save_record(record: dict, out_dir=None) -> Path:
    path = record_path(record["arch"], record["shape"], record["mesh"], record.get("tag", ""),
                       out_dir)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(record, indent=2, default=str))
    return path


def parse_sets(items) -> dict:
    """``--set KEY=VALUE`` overrides: ``dtype`` by name, integers as
    integers, anything else as text."""
    out = {}
    for kv in items:
        k, v = kv.split("=", 1)
        if k == "dtype":
            v = {"float32": torch.float32, "bfloat16": torch.bfloat16}[v]
        else:
            try:
                v = int(v)
            except ValueError:
                pass
        out[k] = v
    return out


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true", help="run every remaining cell")
    ap.add_argument("--force", action="store_true", help="re-run cached cells")
    ap.add_argument("--tag", default="", help="variant tag (perf experiments)")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="ModelConfig override, e.g. --set n_layers=2")
    args = ap.parse_args(argv)
    cfg_overrides = parse_sets(args.set) or None

    if args.all:
        cells = [(arch, shape) for arch in ARCHS for shape in SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]
    name = mesh_name(args.multi_pod)
    records = []
    for arch, shape in cells:
        path = record_path(arch, shape, name, args.tag)
        if path.exists() and not args.force:
            prev = json.loads(path.read_text())
            if prev.get("status") in ("ok", "skipped"):
                print(f"[cached] {arch} x {shape} x {name}: {prev['status']}")
                records.append(prev)
                continue
        print(f"[run] {arch} x {shape} x {name} ...", flush=True)
        rec = run_cell(arch, shape, multi_pod=args.multi_pod, tag=args.tag,
                       cfg_overrides=cfg_overrides)
        path = save_record(rec)
        extra = ""
        if rec["status"] == "ok":
            r = rec["roofline"]
            extra = (f" dominant={r['dominant']} compute={r['compute_s']:.4f}s "
                     f"memory={r['memory_s']:.4f}s coll={r['collective_s']:.4f}s")
        elif rec["status"] == "error":
            extra = f" {rec['error'][:200]}"
        print(f"[done] {arch} x {shape} x {name}: {rec['status']}{extra} -> {path}")
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
