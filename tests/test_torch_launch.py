"""The port's serving launcher and shapes against the JAX package's.

* ``repro_torch.launch.serve`` prints what ``repro.launch.serve`` prints,
  byte for byte, for the same flags (rates, the DRS split and model E[T],
  the DES report): the reference's default-rate fallback, Program (6)
  sizing and other rates, chips and token counts; on measured rates its
  ``plan`` / ``simulate`` give the reference's split and report.
  The port's ``RESULTS`` points at an empty ``tmp_path`` there, as the
  reference finds no records in its own directory.
* ``rates_from_dryrun`` on a record written by the test into ``tmp_path``
  (the reference's ``{arch}--{shape}--{mesh}.json`` format), equal to the
  reference's; a missing or failed record raises as the reference does,
  and the launcher then falls back to the defaults.  The port's own
  dry-run records (``launch/dryrun.py``) plan the launcher's split as
  ``"dry-run roofline"``.
* ``configs/shapes.py``: ``SHAPES``, ``cell_is_supported`` and
  ``skip_reason`` equal the reference's; ``input_specs`` gives meta tensors
  of the reference's shapes and dtypes for the ported architectures.
"""

from __future__ import annotations

import contextlib
import io
import json
import sys

import jax.numpy as jnp
import pytest
import torch

import repro.configs.shapes as jshapes
import repro.launch.serve as jlaunch
from repro.serving.pipeline import ServingModel as JModel
from repro.serving.pipeline import StageRates as JRates
from repro.serving.pipeline import rates_from_dryrun as j_rates_from_dryrun
from repro.serving.router import ServingSimulation as JSim
import repro_torch.configs.shapes as shapes
from repro_torch.configs import ARCHS
from repro_torch.launch import serve as launch
from repro_torch.serving.pipeline import StageRates, rates_from_dryrun

FLAGS = [
    ["--horizon", "300"],
    ["--horizon", "300", "--t-max", "2.0"],
    ["--horizon", "240", "--rate", "6.0", "--chips", "30", "--mean-tokens", "32"],
    ["--arch", "zamba2-7b", "--horizon", "200", "--rate", "2.0", "--chips", "16"],
    ["--arch", "whisper-medium", "--horizon", "200", "--rate", "3.0", "--chips", "20"],
]


def _stdout(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue()


def _ref_main(argv):
    old = sys.argv
    sys.argv = ["serve", *argv]
    try:
        jlaunch.main()
    finally:
        sys.argv = old


@pytest.mark.parametrize("argv", FLAGS, ids=[" ".join(f) for f in FLAGS])
def test_launcher_prints_what_the_reference_launcher_prints(argv, tmp_path, monkeypatch):
    monkeypatch.setattr(launch, "RESULTS", tmp_path)  # no records, as the reference finds none
    got = _stdout(lambda: launch.main(argv))
    want = _stdout(lambda: _ref_main(argv))
    assert got == want
    assert "defaults (no dry-run records found)" in got


@pytest.mark.parametrize("prefill,decode", [(38.4, 860.0), (2.1, 75.0), (0.5, 40.0)])
def test_measured_rates_give_the_reference_split_and_report(prefill, decode):
    """The card's rates (``--prefill-rate`` / ``--decode-rate``) through the
    launcher's ``plan`` and ``simulate``: the split, E[T] and every report
    field equal the reference's ``ServingModel`` / ``ServingSimulation`` on
    the same rates."""
    rates, src = launch.stage_rates("llama3.2-1b", prefill_rate=prefill, decode_rate=decode)
    assert src == "measured on the card" and rates == StageRates(prefill, decode)
    model, alloc, split = launch.plan(rates, 4.0, chips=24)
    jmodel = JModel(JRates(prefill, decode), mean_output_tokens=64.0)
    jalloc = jmodel.plan(4.0, k_max=24)
    assert split == jmodel.split(jalloc)
    assert alloc.expected_sojourn == jalloc.expected_sojourn
    rep = launch.simulate(model, split, 4.0, horizon=300.0)
    want = JSim(jmodel, 4.0, horizon=300.0, warmup=30.0).run(split)
    assert json.dumps(rep.as_dict()) == json.dumps(want.as_dict())


def test_stage_rates_needs_both_measured_rates():
    with pytest.raises(ValueError, match="both"):
        launch.stage_rates("llama3.2-1b", prefill_rate=1.0)


def _record(path, arch, shape, *, status="ok", chips=256, roofline=(0.5, 0.8, 0.1)):
    rec = {"status": status, "chips": chips,
           "roofline": dict(zip(("compute_s", "memory_s", "collective_s"), roofline))}
    (path / f"{arch}--{shape}--pod16x16.json").write_text(json.dumps(rec))


def test_rates_from_dryrun_reads_the_reference_record_format(tmp_path):
    _record(tmp_path, "llama3.2-1b", "prefill_32k", roofline=(0.9, 0.4, 0.2))
    _record(tmp_path, "llama3.2-1b", "decode_32k", roofline=(0.002, 0.011, 0.003))
    got = rates_from_dryrun("llama3.2-1b", tmp_path)
    want = j_rates_from_dryrun("llama3.2-1b", tmp_path)
    assert (got.prefill_per_chip, got.decode_per_chip) == (want.prefill_per_chip,
                                                           want.decode_per_chip)
    assert got.prefill_per_chip == 32 / (0.9 * 256)
    rates, src = launch.stage_rates("llama3.2-1b", results_dir=tmp_path)
    assert src == "dry-run roofline" and rates == got


def test_rates_from_dryrun_refuses_missing_and_failed_records(tmp_path):
    with pytest.raises(FileNotFoundError):
        rates_from_dryrun("llama3.2-1b", tmp_path)
    _record(tmp_path, "llama3.2-1b", "prefill_32k", status="oom")
    _record(tmp_path, "llama3.2-1b", "decode_32k")
    with pytest.raises(FileNotFoundError, match="no ok dry-run"):
        rates_from_dryrun("llama3.2-1b", tmp_path)
    with pytest.raises(FileNotFoundError, match="no ok dry-run"):
        j_rates_from_dryrun("llama3.2-1b", tmp_path)
    rates, src = launch.stage_rates("llama3.2-1b", results_dir=tmp_path)
    assert rates == launch.DEFAULT_RATES and src.startswith("defaults")


def test_launcher_plans_from_the_ports_dry_run_records(tmp_path, monkeypatch):
    """Records of ``launch/dryrun.py`` (cut to 2 layers to keep the trace
    short) in the launcher's ``RESULTS``: ``stage_rates`` reports
    ``"dry-run roofline"`` with the rates ``rates_from_dryrun`` reads, and
    ``main`` plans and simulates a split from them."""
    from repro_torch.launch import dryrun

    for shape in ("prefill_32k", "decode_32k"):
        rec = dryrun.run_cell("llama3.2-1b", shape, cfg_overrides={"n_layers": 2})
        assert rec["status"] == "ok"
        dryrun.save_record(rec, tmp_path)
    monkeypatch.setattr(launch, "RESULTS", tmp_path)
    rates, src = launch.stage_rates("llama3.2-1b")
    assert src == "dry-run roofline" and rates == rates_from_dryrun("llama3.2-1b", tmp_path)
    res = launch.main(["--horizon", "120"])
    assert res["source"] == "dry-run roofline" and res["split"]["prefill"] >= 1
    assert res["report"].completed > 0


def test_shapes_equal_the_references():
    assert set(shapes.SHAPES) == set(jshapes.SHAPES)
    for name, spec in jshapes.SHAPES.items():
        got = shapes.SHAPES[name]
        assert (got.name, got.seq_len, got.global_batch, got.kind) == (
            spec.name, spec.seq_len, spec.global_batch, spec.kind)
    for arch in ARCHS:
        for name in jshapes.SHAPES:
            assert shapes.cell_is_supported(arch, name) == jshapes.cell_is_supported(arch, name)
            assert shapes.skip_reason(arch, name) == jshapes.skip_reason(arch, name)


_DT = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-1.6b", "zamba2-7b", "phi3-medium-14b",
                                  "yi-34b", "command-r-35b", "mixtral-8x22b",
                                  "kimi-k2-1t-a32b", "qwen2-vl-2b", "whisper-medium"])
@pytest.mark.parametrize("shape", sorted(jshapes.SHAPES))
def test_input_specs_are_meta_tensors_of_the_reference_shapes(arch, shape):
    got = shapes.input_specs(arch, shape)
    want = jshapes.input_specs(arch, shape)
    assert set(got) == set(want)
    for key, sds in want.items():
        t = got[key]
        assert t.device.type == "meta" and tuple(t.shape) == tuple(sds.shape), key
        assert t.dtype == _DT[jnp.dtype(sds.dtype).type], key


def test_input_specs_of_an_unported_arch_name_its_roadmap_item():
    """whisper's train and prefill batches carry the encoder's stub frames
    [B, enc_seq, D] in bf16, as the reference's do; its decode batch does
    not (the cross keys and values are in the cache)."""
    for shape in ("train_4k", "prefill_32k"):
        got = shapes.input_specs("whisper-medium", shape)
        want = jshapes.input_specs("whisper-medium", shape)
        b = shapes.SHAPES[shape].global_batch
        assert tuple(got["frames"].shape) == tuple(want["frames"].shape) == (b, 1500, 1024)
        assert got["frames"].dtype == torch.bfloat16 and got["frames"].device.type == "meta"
    assert set(shapes.input_specs("whisper-medium", "decode_32k")) == {"tokens"}
