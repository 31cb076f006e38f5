"""The port's dry-run (``launch/dryrun.py``, ``launch/trace_cost.py``)
against the JAX package's.

* One subprocess runs the reference's ``repro.launch.dryrun.run_cell`` on
  the ten cells of ``CELLS``, cut in depth (its XLA flags stay in that
  process); the port's records of the same cells have the reference's
  argument and output bytes and ``model_flops`` exactly.
* Dot FLOPs per device: within 5 % of the reference's on the decode cells
  (mixtral's less the keys outside its 4,096-token window, which the
  reference attends to masked and the port's kernel does not read); on the
  prefill cells within 5 % of the reference's less the non-causal half of
  its ``attn_impl="naive"`` score and PV products (the port's flash kernel
  visits the causal pairs); the train cell's ratio pinned between 0.35 and
  0.45 -- both packages rematerialise every layer (four forwards of the
  layers, three of the head), but the reference's partitioner lays the
  attention out with the batch whole on every device
  (``f32[256,2,4096,4096]`` score dots per device: heads over "model"
  only), so it does 16 times a 256-way split's attention work -- and the
  port's train FLOPs equal four forwards of its layers and three of its
  head (the head runs outside any checkpoint) by its own count; the three
  ``long_500k`` cells (batch 1, a 524,288-row cache) each in a stated band
  (``LONG_FLOP_BANDS``: XLA spreads the batch-1 step over the idle "data"
  axis; mixtral's reference reads its whole cache under the window's mask).
* Collective bytes by kind, port / reference, each within a stated band
  with its reason (``COLLECTIVE_BANDS``), and every serving record's
  dominant term unchanged when the reference's collective bytes replace
  the port's at the port's link rate (``HW.link``): the cut serving cells,
  the twelve full-depth records the serving launcher plans from and the
  three full-depth ``long_500k`` records.
* Collectives on hand-computed cases: a tensor-parallel block, an FSDP and
  a data-parallel parameter, an expert-parallel MoE layer (prefill and
  train), a sequence-sharded decode attention, a product whose
  activation is split along its contracted dim, and an FSDP parameter at
  batch 1 (contracted over its axis, not gathered).
* The kernels' work counts (``kernels/cost.py``) equal what ``chip_smoke.py``
  computed inline before they moved, on its case tables; the meta faces
  give the plain versions' shapes and dtypes and, under autograd, the
  inputs' gradients.
* A port record reads alike through both packages' ``rates_from_dryrun``;
  ``main(["--all", ...])`` writes an ``ok`` or ``skipped`` record for every
  one of the 40 single-pod cells (cut to 2 layers), none in ``error``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro.serving.pipeline import rates_from_dryrun as j_rates_from_dryrun
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.shapes import SHAPES, cell_is_supported
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import cost
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention import ref as decode_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.rwkv6_scan import ops as rwkv6_ops
from repro_torch.kernels.rwkv6_scan import ref as rwkv6_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.kernels.swiglu import ops as swiglu_ops
from repro_torch.kernels.swiglu import ref as swiglu_ref
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import HW, LogicalMesh
from repro_torch.launch.trace_cost import CostTrace
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import param_shapes
from repro_torch.serving.pipeline import rates_from_dryrun

ROOT = pathlib.Path(__file__).resolve().parents[1]

CELLS = [
    ("llama3.2-1b", "decode_32k", {"n_layers": 2}),
    ("llama3.2-1b", "prefill_32k", {"n_layers": 2}),
    ("llama3.2-1b", "train_4k", {"n_layers": 2}),
    ("mixtral-8x22b", "decode_32k", {"n_layers": 1}),
    ("whisper-medium", "prefill_32k", {"n_layers": 2, "enc_layers": 2}),
    ("zamba2-7b", "prefill_32k", {"n_layers": 2}),
    ("rwkv6-1.6b", "decode_32k", {"n_layers": 2}),
    ("rwkv6-1.6b", "long_500k", {"n_layers": 2}),
    ("zamba2-7b", "long_500k", {"n_layers": 2}),
    ("mixtral-8x22b", "long_500k", {"n_layers": 1}),
]
IDS = [f"{a}-{s}" for a, s, _o in CELLS]

_REF_SCRIPT = """
import json, sys
from repro.launch.dryrun import run_cell
cells = json.loads(sys.argv[1])
out = []
for arch, shape, over in cells:
    rec = run_cell(arch, shape, cfg_overrides=over)
    rec.pop("traceback", None)
    out.append(rec)
json.dump(out, open(sys.argv[2], "w"), default=str)
"""


@pytest.fixture(scope="module")
def ref_records(tmp_path_factory):
    """The reference's records of ``CELLS``, from one subprocess (its
    dry-run sets ``XLA_FLAGS`` at import)."""
    out = tmp_path_factory.mktemp("ref_dryrun") / "cells.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _REF_SCRIPT, json.dumps(CELLS), str(out)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    recs = json.loads(out.read_text())
    assert all(r["status"] == "ok" for r in recs), [r.get("error") for r in recs]
    return {(r["arch"], r["shape"]): r for r in recs}


@pytest.fixture(scope="module")
def port_records():
    return {(a, s): dryrun.run_cell(a, s, cfg_overrides=o) for a, s, o in CELLS}


@pytest.mark.parametrize("cell", CELLS, ids=IDS)
def test_argument_and_output_bytes_and_model_flops_equal_the_references(
        cell, ref_records, port_records):
    arch, shape, _over = cell
    got, want = port_records[(arch, shape)], ref_records[(arch, shape)]
    assert got["status"] == "ok", got.get("error")
    for key in ("argument_size_in_bytes", "output_size_in_bytes"):
        assert got["memory_analysis"][key] == want["memory_analysis"][key], key
    assert got["roofline"]["model_flops"] == want["roofline"]["model_flops"]
    assert got["chips"] == want["chips"] == 256 and got["mesh"] == want["mesh"]
    assert got["hw"]["peak_flops_bf16"] == 989e12 and got["hw"]["link_bw"] == HW.NET_BW


def _ref_attention_the_port_skips(arch, shape, over):
    """Per-device dot FLOPs of the reference's attention that the port's
    kernels do not do: the non-causal pairs of each causal self-attention
    layer at prefill (batch and heads over 256 devices), the keys outside
    the window at decode (batch over "data", the cache's sequence over
    "model", every head)."""
    cfg = dataclasses.replace(get_config(arch, "full"), **over)
    spec = SHAPES[shape]
    b, s, dh, hq = spec.global_batch, spec.seq_len, cfg.head_dim_, cfg.n_heads
    if spec.kind == "decode":
        if cfg.attention != "swa":
            return 0.0
        return cfg.n_layers * 4 * dh * (s - cfg.swa_window) / 16 * (b / 16) * hq
    causal_layers = (-(-cfg.n_layers // cfg.hybrid_attn_every) if cfg.family == "hybrid"
                     else cfg.n_layers)
    skipped = s * s - cost.attention_pairs(s, s, True, None)
    return causal_layers * 4 * dh * skipped * b * hq / 256


def _dense_forward_flops(cfg, b, s):
    """Global dot FLOPs of one forward of a dense (tied-embedding) model:
    (its layers', its head's)."""
    d = cfg.d_model
    per_layer = d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d + 3 * d * cfg.d_ff
    attn = 4 * cfg.head_dim_ * cost.attention_pairs(s, s, True, None) * b * cfg.n_heads
    return cfg.n_layers * (2 * per_layer * b * s + attn), 2 * d * cfg.vocab * b * s


#: arch -> (lo, hi, reason): the port / reference dot FLOPs per device of
#: its ``long_500k`` cell in ``CELLS``.  At batch 1 the batch takes no mesh
#: axis, and XLA spreads some of the replicated step over the idle "data"
#: axis, where the port's trace splits work as the rules lay out its
#: operands (the serve-time weights replicated over "data").
LONG_FLOP_BANDS = {
    "rwkv6-1.6b": (
        1.70, 1.80, "XLA splits each layer's r / k / v / g / o and channel-mix products "
                    "over both mesh axes ([128, 128] blocks a device); the port's trace "
                    "16-way, over 'model'; the head, the largest product, agrees"),
    "zamba2-7b": (
        1.65, 1.78, "both score all 32 heads over the device's 32,768 keys, but XLA splits "
                    "the PV product over heads on 'data' too ([2, 112] a device), where the "
                    "port's kernel does both products on its sequence shard; the "
                    "projections agree"),
    "mixtral-8x22b": (
        0.055, 0.07, "the reference's attention reads all 524,288 cache rows with the "
                     "window masked ([8, 6, 32768] scores a device), the port's kernel the "
                     "window's 4,096; the projections and the experts ([8, 384, 1024] "
                     "blocks a device, 256-way) agree"),
}


@pytest.mark.parametrize("cell", CELLS, ids=IDS)
def test_dot_flops_per_device_agree_with_the_references(cell, ref_records, port_records):
    arch, shape, over = cell
    got = port_records[(arch, shape)]["roofline"]["flops_per_device"]
    want = ref_records[(arch, shape)]["roofline"]["flops_per_device"]
    ratio = got / want
    print(f"\n{arch} {shape}: port / reference dot FLOPs per device {ratio:.4f}")
    if shape == "long_500k":
        lo, hi, reason = LONG_FLOP_BANDS[arch]
        assert lo <= ratio <= hi, (ratio, reason)
        return
    if SHAPES[shape].kind == "train":
        assert 0.35 <= ratio <= 0.45, ratio
        cfg = dataclasses.replace(get_config(arch, "full"), **over)
        spec = SHAPES[shape]
        layers, head = _dense_forward_flops(cfg, spec.global_batch, spec.seq_len)
        # the layers: forward, recompute, backward's two; the head: forward, backward's two
        assert got == pytest.approx((4 * layers + 3 * head) / 256, rel=1e-3)
        return
    adjusted = want - _ref_attention_the_port_skips(arch, shape, over)
    assert got / adjusted == pytest.approx(1.0, abs=0.05), (ratio, got / adjusted)


def test_collective_and_traffic_ratios_to_the_reference(ref_records, port_records):
    """Printed (``pytest -s``) for the record; the two count collectives
    and traffic with different models, so nothing is asserted past both
    being there."""
    for arch, shape, _o in CELLS:
        got, want = port_records[(arch, shape)], ref_records[(arch, shape)]
        g, w = got["roofline"], want["roofline"]
        kinds = sorted(set(g["collectives"]["bytes_by_kind"]) | set(
            w["collectives"]["bytes_by_kind"]))
        parts = []
        for k in kinds:
            gb = g["collectives"]["bytes_by_kind"].get(k, 0.0)
            wb = w["collectives"]["bytes_by_kind"].get(k, 0.0)
            parts.append(f"{k} {gb:.4g}/{wb:.4g}")
        print(f"\n{arch} {shape}: traffic {g['bytes_per_device']:.4g} / "
              f"{w['bytes_per_device']:.4g} = {g['bytes_per_device'] / w['bytes_per_device']:.4f}; "
              f"collectives {g['collective_bytes_per_device']:.4g} / "
              f"{w['collective_bytes_per_device']:.4g}; " + ", ".join(parts))
        assert g["bytes_per_device"] > 0 and g["collective_bytes_per_device"] > 0


#: Why a port / reference ratio is not 1, the reasons the bands share.
_F32 = ("the reference's collectives run in float32 (XLA's CPU backend widens bf16), the "
        "port's carry the model's bf16: 0.5 for the same collective")
_ROPE = ("XLA splits the 64-wide head dim of the 8 KV heads (which 16 does not divide) "
         "and rotates its halves across devices; the port applies RoPE to whole heads")
_KV = ("XLA gathers the rotated keys and values into the cache's layout (8 KV heads over "
       "a 16-wide model axis); the port writes its shard and its kernel reads it there")
_EMBED = "the reference also all-reduces the rows gathered from the vocab-sharded embedding"

#: (arch, shape, kind) -> (lo, hi, reason): the band of port / reference
#: collective bytes of that kind in ``CELLS``; for a kind the reference
#: lacks, of the port's bytes over the reference's total.
COLLECTIVE_BANDS = {
    ("llama3.2-1b", "decode_32k", "all-reduce"): (
        0.30, 0.38, f"{_F32}; {_EMBED}; the same two tensor-parallel all-reduces and "
        "flash-decoding combine per layer"),
    ("llama3.2-1b", "decode_32k", "all-gather"): (0.0, 0.0, _KV),
    ("llama3.2-1b", "decode_32k", "all-to-all"): (0.0, 0.0, _ROPE),
    ("llama3.2-1b", "decode_32k", "collective-permute"): (0.0, 0.0, _ROPE),
    ("llama3.2-1b", "prefill_32k", "all-reduce"): (
        0.38, 0.42, f"{_F32}; {_EMBED} (a fifth [B, S, D] beside the four of wo and the "
        "SwiGLU): 0.5 x 4 / 5"),
    ("llama3.2-1b", "prefill_32k", "all-gather"): (0.0, 0.0, _KV),
    ("llama3.2-1b", "prefill_32k", "all-to-all"): (0.0, 0.0, _ROPE),
    ("llama3.2-1b", "prefill_32k", "collective-permute"): (0.0, 0.0, _ROPE),
    ("llama3.2-1b", "train_4k", "all-reduce"): (
        0.05, 0.08, f"{_F32}; the reference keeps the batch whole in its layers' "
        "activations ([256, 4096, .] per device, 16x the port's data-split batch) and "
        "all-reduces its vocab-sharded logits ([256, 4096, 8016] float32)"),
    ("llama3.2-1b", "train_4k", "all-gather"): (
        0.002, 0.004, "the reference gathers its batch-whole logits (3.4e10 bytes) and "
                      "keys; the port's are the FSDP gathers of the parameters"),
    ("llama3.2-1b", "train_4k", "all-to-all"): (0.0, 0.0, _ROPE),
    ("llama3.2-1b", "train_4k", "collective-permute"): (0.0, 0.0, _ROPE),
    ("llama3.2-1b", "train_4k", "reduce-scatter"): (
        0.0, 1e-4, "the port reduce-scatters its FSDP gradients (3.0e6 bytes); XLA "
                   "all-reduces the reference's"),
    ("mixtral-8x22b", "decode_32k", "all-gather"): (
        5.0, 6.5, "the port's serve-time FSDP gathers every expert whole (experts on "
                  "'data': 363 MB a layer); XLA gathers the router, the attention and "
                  "the head and reduces the experts' activations"),
    ("mixtral-8x22b", "decode_32k", "all-reduce"): (
        0.08, 0.13, f"{_F32}; the reference all-reduces its experts' partial products "
                    "([8, 40, 1024] float32), which the port's gathered experts skip"),
    ("mixtral-8x22b", "decode_32k", "all-to-all"): (
        0.0, 0.0, f"the reference dispatches its routed tokens by all-to-all; {_ROPE}"),
    ("mixtral-8x22b", "decode_32k", "collective-permute"): (
        0.0, 0.0, f"the reference permutes its routing tables; {_ROPE}"),
    ("whisper-medium", "prefill_32k", "all-reduce"): (
        0.49, 0.51, f"{_F32}; otherwise the same all-reduces: wo and the MLP's down "
                    "projection per layer, on the encoder's and the decoder's sequences"),
    ("zamba2-7b", "prefill_32k", "all-reduce"): (
        0.38, 0.42, f"{_F32}; {_EMBED}: 0.5 x 4 / 5"),
    ("zamba2-7b", "prefill_32k", "collective-permute"): (
        0.0, 0.0, "the reference cuts in_proj's and bc_proj's model-sharded outputs in "
                  "halves with jnp.split, which XLA reshards by permutes; the port lays "
                  "each half out on its own heads"),
    ("rwkv6-1.6b", "decode_32k", "all-gather"): (
        0.34, 0.42, f"{_F32}; both gather the four time-mix and two channel-mix shifted "
                    "inputs per layer (the token shift split along d_model, "
                    "dryrun.STEP_LAYOUT); the reference also gathers the shift caches "
                    "back to their declared layout and the last token's residual"),
    ("rwkv6-1.6b", "decode_32k", "all-reduce"): (
        0.37, 0.43, f"{_F32}; {_EMBED}; the same wo, channel-mix and decay-LoRA "
                    "reductions per layer"),
    ("rwkv6-1.6b", "decode_32k", "all-to-all"): (
        0.0, 0.0, "the reference reshards its embedding rows by all-to-all"),
    ("rwkv6-1.6b", "decode_32k", "collective-permute"): (
        0.0, 0.0, "the reference reshards its embedding rows by a permute"),
    # long_500k: batch 1 takes no mesh axis, so XLA lays the step out over
    # both axes (LONG_FLOP_BANDS); the sequence-sharded cache's combine is
    # an all-reduce in both.
    ("rwkv6-1.6b", "long_500k", "all-gather"): (
        1.25, 1.35, "the port gathers each of the six shifted mixes a layer whole over "
                    "'model' ([1, 2048] bf16); XLA moves them between its 256-way product "
                    "layout and the shifts' by collective-permutes of [1, 1, 128] float32 "
                    "blocks and gathers only the stacked shift caches ([2, 1, 2048] "
                    "float32) and the last residual"),
    ("rwkv6-1.6b", "long_500k", "all-reduce"): (
        1.35, 1.45, f"{_F32}; the port reduces wo's and the channel mix's [1, 2048] outputs "
                    "over 'model'; XLA splits those products 256-way and reduces "
                    "128-wide float32 blocks"),
    ("rwkv6-1.6b", "long_500k", "collective-permute"): (
        0.0, 0.0, "XLA's permutes of the shifted mixes between its layouts (see all-gather)"),
    ("zamba2-7b", "long_500k", "all-reduce"): (
        0.45, 0.55, f"{_F32}; {_EMBED}; both reduce the two mamba layers' out_proj, the "
                    "site's wo and SwiGLU down projection, and combine the "
                    "sequence-sharded cache's partial softmax (the port: the [1, 32, 112] "
                    "output and two [1, 32] statistics; XLA: two statistics and a "
                    "[1, 2, 1, 112] output, its PV product split over heads on 'data')"),
    ("zamba2-7b", "long_500k", "all-gather"): (
        0.0, 0.0, "XLA gathers the rotated query, key and value ([1, 1, 32, 112] float32) "
                  "into its attention's layout; the port's kernel reads the step's row "
                  "where it writes it"),
    ("zamba2-7b", "long_500k", "collective-permute"): (
        0.0, 0.0, "the reference cuts in_proj's model-sharded output with jnp.split, "
                  "which XLA reshards by permutes, and permutes its PV output between "
                  "layouts; the port lays each half out on its own heads"),
    ("mixtral-8x22b", "long_500k", "all-reduce"): (
        0.55, 0.68, f"{_F32}; with the batch off 'data', d_model on 'data' is a "
                    "contraction there in both (the experts' [8, 1, 1024] and [8, 1, 384] "
                    "partial products, q / k / v, the router and the head reduced; no "
                    "expert gathered), beside wo's and the cache's partial-softmax "
                    "combine; XLA also reduces its routing statistics"),
    ("mixtral-8x22b", "long_500k", "all-gather"): (
        0.0, 0.0, "XLA gathers the rotated queries, keys and values and RoPE's halves "
                  "into its attention's layout (its scores over all 524,288 rows, the "
                  "window masked); the port's kernel reads the window's rows of its "
                  "sequence shard in place"),
    ("mixtral-8x22b", "long_500k", "collective-permute"): (
        0.0, 0.0, f"{_ROPE}; XLA permutes its PV output between layouts"),
}


def _kinds(rec) -> dict:
    return rec["roofline"]["collectives"]["bytes_by_kind"]


def test_every_collective_kind_of_the_cells_has_a_band(ref_records, port_records):
    for arch, shape, _o in CELLS:
        kinds = set(_kinds(port_records[(arch, shape)])) | set(
            _kinds(ref_records[(arch, shape)]))
        assert kinds == {k for a, s, k in COLLECTIVE_BANDS if (a, s) == (arch, shape)}, \
            (arch, shape, kinds)


@pytest.mark.parametrize("arch,shape,kind", list(COLLECTIVE_BANDS),
                         ids=[f"{a}-{s}-{k}" for a, s, k in COLLECTIVE_BANDS])
def test_collective_bytes_per_kind_are_within_the_stated_band(arch, shape, kind, ref_records,
                                                              port_records):
    lo, hi, reason = COLLECTIVE_BANDS[(arch, shape, kind)]
    got = _kinds(port_records[(arch, shape)]).get(kind, 0.0)
    want = _kinds(ref_records[(arch, shape)])
    ratio = got / want[kind] if want.get(kind) else got / sum(want.values())
    assert lo <= ratio <= hi, (ratio, reason)


#: The serving records the launcher plans from (``chip_smoke.DRYRUN_ARCHS``
#: at full depth on pod16x16), and the three ``long_500k`` records
#: ``chip_smoke.py`` writes at full depth.
PLANNED = [(arch, shape) for arch in ("llama3.2-1b", "rwkv6-1.6b", "zamba2-7b", "phi3-medium-14b",
                                      "qwen2-vl-2b", "whisper-medium")
           for shape in ("prefill_32k", "decode_32k")] + [
    (arch, "long_500k") for arch in ("rwkv6-1.6b", "zamba2-7b", "mixtral-8x22b")]


@pytest.fixture(scope="module")
def planned_records(tmp_path_factory):
    """(the reference's, the port's) records of ``PLANNED``."""
    out = tmp_path_factory.mktemp("ref_planned") / "cells.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    cells = [(a, s, None) for a, s in PLANNED]
    res = subprocess.run([sys.executable, "-c", _REF_SCRIPT, json.dumps(cells), str(out)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    ref = {(r["arch"], r["shape"]): r for r in json.loads(out.read_text())}
    return ref, {(a, s): dryrun.run_cell(a, s) for a, s in PLANNED}


SERVING = [(a, s, "cut") for a, s, _o in CELLS if SHAPES[s].kind != "train"] + [
    (a, s, "full") for a, s in PLANNED]


@pytest.mark.parametrize("arch,shape,depth", SERVING,
                         ids=[f"{a}-{s}-{d}" for a, s, d in SERVING])
def test_serving_dominant_term_holds_under_the_references_collectives(
        arch, shape, depth, request):
    """The port's record's compute and memory terms beside the reference's
    collective bytes over the port's link (``HW.link`` of pod16x16): the
    dominant term is the record's own."""
    if depth == "cut":
        ref = request.getfixturevalue("ref_records")
        got = request.getfixturevalue("port_records")[(arch, shape)]
    else:
        ref, port = request.getfixturevalue("planned_records")
        got = port[(arch, shape)]
    want = ref[(arch, shape)]
    assert got["status"] == want["status"] == "ok"
    r = got["roofline"]
    link = HW.link(LogicalMesh((16, 16), ("data", "model")))[1]
    assert got["hw"]["link_bw"] == link
    terms = {"compute": r["compute_s"], "memory": r["memory_s"],
             "collective": want["roofline"]["collective_bytes_per_device"] / link}
    assert max(terms, key=terms.get) == r["dominant"], (terms, r["collective_s"])


# --------------------------------------------------------------------------- #
# Collectives on hand-computed cases
# --------------------------------------------------------------------------- #
TINY = ModelConfig(arch="tiny", family="dense", n_layers=1, d_model=64, n_heads=8,
                   n_kv_heads=4, d_ff=128, vocab=256, head_dim=8, dtype=torch.bfloat16,
                   tie_embeddings=True)
TINY_MOE = dataclasses.replace(TINY, arch="tiny-moe", family="moe", n_experts=8, top_k=2,
                               moe_d_ff=32)


def _cost(cfg, kind, b, s, shape):
    mesh = LogicalMesh(shape, ("data", "model"))
    return dryrun.step_cost(cfg, kind, b, s, mesh, shd.rules_for(kind))[1]


def test_tensor_parallel_block_all_reduces_its_two_contractions():
    """Prefill, B 4 x S 16 on (data 2, model 4): ``wo`` contracts the heads
    and the SwiGLU's down projection ``d_ff``, both on "model": two
    all-reduces of the [B / 2, S, D] bf16 output."""
    c = _cost(TINY, "prefill", 4, 16, (2, 4))
    one = 2 * 16 * 64 * 2
    assert c.bytes_by_kind == {"all-reduce": 2 * one}
    assert c.count_by_kind == {"all-reduce": 2}


def test_fsdp_and_data_parallel_parameters():
    """A [3, 8, 16] parameter with d_model on "data" (4) and d_ff on
    "model" (2): gathered over "data" before its forward and its backward
    use, its gradient reduce-scattered, once per layer; a [8] parameter on
    no batch axis: its gradient all-reduced."""
    mesh = LogicalMesh((4, 2), ("data", "model"))
    trace = CostTrace(mesh, shd.prune_rules(shd.rules_for("train"), mesh))
    trace.register(torch.empty(3, 8, 16, dtype=torch.bfloat16, device="meta"),
                   (None, "data", "model"), "param", "layers.w", ("layers", "d_model", "d_ff"))
    trace.register(torch.empty(8, dtype=torch.bfloat16, device="meta"), (None,), "param",
                   "scale", (None,))
    trace.parameter_collectives(train=True)
    assert trace.cost.bytes_by_kind == {"all-gather": 2 * 3 * 8 * 16 * 2 / 2,
                                        "reduce-scatter": 3 * 8 * 16 * 2 / 8,
                                        "all-reduce": 8 * 2}
    assert trace.cost.count_by_kind == {"all-gather": 6, "reduce-scatter": 3, "all-reduce": 1}


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_expert_parallel_layer_costs_two_all_to_alls_each_way(kind):
    """8 experts over "data" (4), B 4 x S 16: the dispatch buffer [E, C, D]
    (C = int(1.25 * 64 * 2 / 8) = 20) is 20,480 bf16 bytes, a device's
    quarter 5,120; two all-to-alls per MoE layer, in training two more in
    the backward's recompute of the rematerialised layer and two in the
    backward proper."""
    c = _cost(TINY_MOE, kind, 4, 16, (4, 2))
    n = 2 if kind == "prefill" else 6
    assert c.count_by_kind["all-to-all"] == n
    assert c.bytes_by_kind["all-to-all"] == n * 8 * 20 * 64 * 2 / 4


def test_sequence_sharded_decode_attention_combines_its_partials():
    """Decode, B 4 over a 32-row cache on (data 2, model 4): the cache's
    sequence takes "model" (its 4 KV heads stay whole), so each device
    attends 8 rows for its 2 sequences and all 8 heads and the partial
    softmax combines over "model": [2, 8, 8] bf16 plus two [2, 8] float32;
    beside it the two tensor-parallel all-reduces of [2, 64] bf16."""
    c = _cost(TINY, "decode", 4, 32, (2, 4))
    combine = 2 * 8 * (8 * 2 + 2 * 4)
    assert c.bytes_by_kind == {"all-reduce": combine + 2 * (2 * 64 * 2)}
    assert c.count_by_kind == {"all-reduce": 3}
    assert c.kernel_calls == {"decode_attention": 1, "swiglu": 1}


@pytest.mark.parametrize("b", [2, 1])
def test_an_fsdp_dim_is_gathered_unless_the_batch_leaves_its_axis_free(b):
    """Decode on (data 2, model 4) with d_model on "data" (mixtral's
    serve-time FSDP): at B = 2 the batch takes "data" and each layer's
    parameters are gathered over it; at B = 1 (``long_500k``) the batch
    takes no axis, so a product contracting d_model on "data" is an
    all-reduce of its output there, as XLA lays it out, and nothing is
    gathered."""
    c = dryrun.step_cost(TINY, "decode", b, 32, LogicalMesh((2, 4), ("data", "model")),
                         shd.rules_for("decode", {"d_model": "data"}))[1]
    if b == 2:
        assert c.bytes_by_kind["all-gather"] > 0
        return
    # over "data": q [1, 64] / 4, k and v [1, 32] / 4 and the tied head's
    # [1, 256] / 4 (bf16, their columns on "model"); over "model": the
    # combine (8 heads x (8 x 2 + 2 x 4)), wo's [1, 64] / 2 and the
    # SwiGLU's down projection [1, 64]
    assert c.bytes_by_kind == {"all-reduce": 32 + 16 + 16 + 128 + 192 + 64 + 128}
    assert c.count_by_kind == {"all-reduce": 7}


def test_an_activation_split_along_its_contracted_dim_is_gathered_or_reduced():
    """A [4, 64] bf16 activation on (data 2, model 4), its 64 split over
    "model": against a [64, 32] weight whose columns take "model" it is
    gathered whole over "model" first (its [2, 64] per-device shard, 256
    bytes); against a [64, 8] weight on no axis the weight's rows are sliced
    to match and the [2, 8] output all-reduced (32 bytes)."""
    mesh = LogicalMesh((2, 4), ("data", "model"))
    trace = CostTrace(mesh, shd.prune_rules(shd.rules_for("decode"), mesh))
    x, w, u = _meta(4, 64), _meta(64, 32), _meta(64, 8)
    trace.register(x, ("data", "model"), "cache", "x")
    trace.register(w, (None, "model"), "param", "w", ("d_model", "heads"))
    trace.register(u, (None, None), "param", "u", ("d_model", None))
    with trace:
        x @ w
        x @ u
    assert trace.cost.bytes_by_kind == {"all-gather": 2 * 64 * 2, "all-reduce": 2 * 8 * 2}
    assert trace.cost.count_by_kind == {"all-gather": 1, "all-reduce": 1}
    assert trace.cost.flops == 2 * 4 * 64 * 32 / 8 + 2 * 4 * 64 * 8 / 8


def test_one_device_mesh_has_no_collectives_and_the_cards_bound():
    """On a one-device mesh nothing is collective, and llama's 4 x 4096
    prefill costs its three forward products plus the causal attention."""
    mesh = LogicalMesh((1, 1, 1), ("pod", "data", "model"))
    cfg = get_config("llama3.2-1b", "full")
    mem, c = dryrun.step_cost(cfg, "prefill", 4, 4096, mesh, shd.rules_for("prefill"))
    assert c.bytes_by_kind == {}
    d = cfg.d_model
    per_layer = d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d + 3 * d * cfg.d_ff
    attn = 4 * cfg.head_dim_ * cost.attention_pairs(4096, 4096, True, None) * 4 * cfg.n_heads
    want = cfg.n_layers * (2 * per_layer * 4 * 4096 + attn) + 2 * d * cfg.vocab * 4
    assert c.flops == pytest.approx(want, rel=1e-9)
    weights = sum(2 * math.prod(shape) for shape in _leaf_shapes(param_shapes(cfg)))
    assert mem["argument_size_in_bytes"] == weights + \
        2 * cfg.n_layers * 4 * 4096 * cfg.kv_dim * 2 + 4 * 4096 * 4


def _leaf_shapes(tree):
    for v in tree.values():
        yield from (_leaf_shapes(v) if isinstance(v, dict) else [v[0]])


# --------------------------------------------------------------------------- #
# The kernels' work and meta faces
# --------------------------------------------------------------------------- #
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _old_scan_work(kind, b, h, s, dk, dv, chunk, size, shared_bc=False):
    """``chip_smoke.py``'s inline count before it moved (one chunk at a
    time)."""
    ops = shared_ops = mma = 0
    for c0 in range(0, s, chunk):
        c = min(chunk, s - c0)
        tri = c * (c + 1) // 2
        if kind == "rwkv6":
            mma += 2 * c * dk * dv + 2 * tri * dv + 2 * c * dk * dv
            ops += (2 * c * dk * dv + 5 * (tri - c) * dk + 3 * c * dk + 2 * tri * dv
                    + 4 * c * dk + 2 * c * dk * dv + 3 * dk * dv)
        else:
            shared_ops += 2 * tri * dk
            mma += 2 * c * dk * dv + 2 * tri * dv + 2 * c * dk * dv
            ops += (3 * tri + 2 * c * dk * dv + 2 * tri * dv + 4 * c * dk
                    + 2 * c * dk * dv + 2 * dk * dv)
    shared_ops *= b * (1 if shared_bc else h)
    ops = b * h * ops + shared_ops
    mma = b * h * mma + shared_ops
    state = 2 * b * h * dk * dv * 4
    if kind == "rwkv6":
        nbytes = b * h * s * ((2 * dk + 2 * dv) * size + 4 * dk) + h * dk * 4 + state
    else:
        bc = 2 * b * (1 if shared_bc else h) * s * dk * size
        nbytes = b * h * s * (2 * dv * size + 4) + bc + state
    return nbytes, ops, mma


def test_kernel_work_equals_the_counts_chip_smoke_made_inline():
    cs = _chip_smoke()
    for _g, arch, b, s, window, causal, _t in cs.FLASH_CASES:
        cfg = get_config(arch, "full")
        hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        sq, skv = s if isinstance(s, tuple) else (s, s)
        pairs = (sum(min(i + 1 + skv - sq, window or skv) for i in range(sq)) if causal
                 else sq * skv)
        old = (2 * b * dh * (2 * sq * hq + 2 * skv * hkv), 4 * dh * pairs * b * hq)
        assert cost.flash_work(b, hq, hkv, sq, skv, dh, causal=causal, window=window) == old
    for _g, arch, b, _smax, length, window, _t in cs.DECODE_CASES:
        cfg = get_config(arch, "full")
        hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        lo = max(0, length - window) if window else 0
        old = (2 * (2 * b * hq * dh + 2 * b * (length - lo) * hkv * dh),
               4 * dh * (length - lo) * b * hq)
        assert cost.decode_work(b, hq, hkv, dh, length - lo) == old
    for _g, arch, t, _dt, _timed in cs.SWIGLU_CASES:
        cfg = get_config(arch, "full")
        d, f = cfg.d_model, cfg.d_ff
        assert cost.swiglu_work(t, d, f) == (2 * (2 * t * d + 3 * d * f), 6 * t * d * f)
    for args in [("rwkv6", 4, 32, 4096, 64, 64, 32, 2), ("rwkv6", 1, 32, 1000, 64, 64, 32, 4),
                 ("rwkv6", 2, 3, 5, 16, 8, 32, 2), ("ssd", 4, 112, 4096, 64, 64, 64, 2, True),
                 ("ssd", 1, 112, 1000, 64, 64, 64, 4, True), ("ssd", 2, 4, 130, 16, 8, 64, 4)]:
        assert cost.scan_work(*args) == _old_scan_work(*args), args


@pytest.mark.parametrize("sq,skv,causal,window", [
    (1, 1, True, None), (7, 7, True, None), (7, 7, True, 3), (5, 9, True, None),
    (5, 9, True, 2), (9, 9, False, None), (100, 100, True, 100), (64, 200, True, 17)])
def test_attention_pairs_closed_form_equals_the_sum(sq, skv, causal, window):
    want = (sum(min(i + 1 + skv - sq, window or skv) for i in range(sq)) if causal
            else sq * skv)
    assert cost.attention_pairs(sq, skv, causal, window) == want


def _meta(*shape, dtype=torch.bfloat16, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta").requires_grad_(grad)


def _cpu_like(t, gen):
    return torch.randn(t.shape, generator=gen).to(t.dtype)


@pytest.mark.parametrize("grad", [False, True])
def test_meta_faces_give_the_plain_versions_shapes_and_gradients(grad):
    gen = torch.Generator().manual_seed(0)
    cases = [
        (lambda q, k, v: flash_ops.attention(q, k, v, window=4), flash_ref.attention,
         (_meta(2, 4, 6, 8, grad=grad), _meta(2, 2, 6, 8, grad=grad), _meta(2, 2, 6, 8, grad=grad)),
         {}),
        (lambda x, wg, wu, wo: swiglu_ops.swiglu(x, wg, wu, wo), swiglu_ref.swiglu,
         (_meta(5, 16, grad=grad), _meta(16, 32, grad=grad), _meta(16, 32, grad=grad),
          _meta(32, 16, grad=grad)), {}),
    ]
    for face, plain, args, _kw in cases:
        got = face(*args)
        want = plain(*(_cpu_like(a, gen) for a in args))
        assert got.device.type == "meta" and got.shape == want.shape and got.dtype == want.dtype
        if grad:
            grads = torch.autograd.grad(got.float().sum(), args)
            assert [g.shape for g in grads] == [a.shape for a in args]
    q, kc, vc = _meta(3, 4, 8), _meta(3, 10, 2, 8), _meta(3, 10, 2, 8)
    n = torch.empty((), dtype=torch.int32, device="meta")
    got = decode_ops.decode_attention(q, kc, vc, n)
    want = decode_ref.decode_attention(*(_cpu_like(t, gen) for t in (q, kc, vc)),
                                       torch.tensor(7, dtype=torch.int32))
    assert got.shape == want.shape and got.dtype == want.dtype
    r, k, v, lw = (_meta(2, 3, 9, 4, grad=grad) for _ in range(4))
    u = _meta(3, 4, grad=grad)
    outs = rwkv6_ops.rwkv6_scan(r, k, v, lw, u, None, chunk=4)
    want = rwkv6_ref.rwkv6_scan(*(_cpu_like(t, gen) for t in (r, k, v)),
                                -torch.rand(2, 3, 9, 4, generator=gen), _cpu_like(u, gen), None,
                                chunk=4)
    assert [(o.shape, o.dtype) for o in outs] == [(w.shape, w.dtype) for w in want]
    x, a = _meta(2, 3, 9, 8, grad=grad), _meta(2, 3, 9, dtype=torch.float32, grad=grad)
    bm = _meta(2, 1, 9, 4, grad=grad).expand(2, 3, 9, 4)
    outs = ssd_ops.ssd_scan(x, a, bm, bm, None, chunk=4)
    want = ssd_ref.ssd_scan(_cpu_like(x, gen), -torch.rand(2, 3, 9, generator=gen),
                            *(_cpu_like(bm, gen) for _ in range(2)), None, chunk=4)
    assert [(o.shape, o.dtype) for o in outs] == [(w.shape, w.dtype) for w in want]
    if grad:
        gx, ga = torch.autograd.grad(outs[0].float().sum() + outs[1].sum(), (x, a))
        assert gx.shape == x.shape and ga.shape == a.shape


def test_meta_kernels_charge_the_active_trace_only():
    mesh = LogicalMesh((1, 1), ("data", "model"))
    trace = CostTrace(mesh, shd.rules_for("prefill"))
    x, w = _meta(5, 16), _meta(16, 32)
    with trace:
        swiglu_ops.swiglu(x, w, w, _meta(32, 16))
    swiglu_ops.swiglu(x, w, w, _meta(32, 16))  # no trace: nothing charged anywhere
    assert trace.cost.kernel_calls == {"swiglu": 1}
    assert trace.cost.flops == cost.swiglu_work(5, 16, 32)[1]
    assert trace.cost.traffic_by_kind["swiglu"] == cost.swiglu_work(5, 16, 32)[0]


# --------------------------------------------------------------------------- #
# Records and the command line
# --------------------------------------------------------------------------- #
def test_a_port_record_reads_alike_in_both_packages(tmp_path):
    for shape in ("prefill_32k", "decode_32k"):
        rec = dryrun.run_cell("zamba2-7b", shape, cfg_overrides={"n_layers": 2})
        assert rec["status"] == "ok"
        path = dryrun.save_record(rec, tmp_path)
        assert path.name == f"zamba2-7b--{shape}--pod16x16.json"
        assert set(json.loads(path.read_text())["roofline"]) >= {
            "compute_s", "memory_s", "collective_s", "dominant", "flops_per_device"}
    got = rates_from_dryrun("zamba2-7b", tmp_path)
    want = j_rates_from_dryrun("zamba2-7b", tmp_path)
    assert (got.prefill_per_chip, got.decode_per_chip) == (want.prefill_per_chip,
                                                           want.decode_per_chip)
    assert got.prefill_per_chip > 0 and got.decode_per_chip > 0


def test_main_all_writes_every_single_pod_cell(tmp_path, capsys, monkeypatch):
    """Every arch x shape on pod16x16, cut to 2 layers (``--set
    n_layers=2``; whisper's encoder keeps its 24): 40 records, each ``ok``
    or ``skipped`` as ``cell_is_supported`` says, none in ``error``; a
    second run reads them back as cached."""
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    recs = dryrun.main(["--all", "--set", "n_layers=2"])
    assert len(recs) == len(ARCHS) * len(SHAPES) == 40
    files = sorted(tmp_path.glob("*--pod16x16.json"))
    assert len(files) == 40
    for rec in recs:
        want = "ok" if cell_is_supported(rec["arch"], rec["shape"]) else "skipped"
        assert rec["status"] == want, (rec["arch"], rec["shape"], rec.get("error"))
        if want == "ok":
            r = rec["roofline"]
            assert r["dominant"] in ("compute", "memory", "collective")
            assert min(r["compute_s"], r["memory_s"]) > 0
    dryrun.main(["--all", "--set", "n_layers=2"])
    assert capsys.readouterr().out.count("[cached]") >= 40
