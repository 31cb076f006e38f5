#!/usr/bin/env python3
"""Time the launch plans of the port's SwiGLU, scan, match-count, fused
decide, flash and decode attention kernels on one CUDA card, at their paths' shapes, to choose their
constants.

    python3 tools/kernel_plans.py                # from the repository root: all
    python3 tools/kernel_plans.py rwkv6_scan     # only the named kernels

- ``rwkv6_scan`` at rwkv6-1.6b's prefill (4 x 4096, 32 heads x 64, chunk
  32, decays over the model's clamp), bf16: the tensor-core kernel at 64,
  32 and 16 columns per block and the CUDA-core kernel, each held to
  ``chip_smoke.SCAN_TOL`` against the plain version;
- ``ssd_scan`` at zamba2-7b's prefill (4 x 4096, 112 heads x 64, state
  64, chunk 64, B / C shared by the heads), bf16: every tensor-core plan
  (heads per block, columns per block) and the CUDA-core kernel, each
  held to ``chip_smoke.SCAN_TOL`` against the plain version;
- ``swiglu`` at the decode shapes (llama3.2-1b and zamba2-7b widths, T 4
  and 16; bf16, and float32 at T 4): the weight-streaming split depth
  ``kernel.STREAM_WAVES`` from 2 to 32 blocks per SM;
- ``match_count`` at the VLD matcher's M = N = 1024, D = 64 and the ragged
  M 1000, N 777, D 50: 16-byte copies (where D allows them) and 4-byte
  ones;
- ``decide_fused`` at the fleet's B 4096, N 7, k_hi = j_cap = 48: the
  packed route at segment widths 8 and 32 (one warp per block), and the
  wide route (one 32-thread block per scenario);
- ``queue_window`` at the fleet's window (B 4096, N 7, 100 steps): the
  segment route at widths 8 and 32, and the wide route (a 32-thread
  block per scenario);
- ``gain_topr`` at the two-pass decide's [4096, 7, 48] tile (warp and
  grid routes), at [256, 40, 48] and at the fleet planner's single
  scenario of 256 and 1,024 tenants ([1, 1298, 2048], [1, 5128, 2048]):
  every route each shape admits, beside the plain version and the bound.
- ``flash`` at the timed flash shapes of ``chip_smoke.FLASH_CASES`` at
  each head dim (llama's and whisper's encoder at 64, kimi's at 112,
  phi3's at 128), bf16: the wgmma kernel's choices (keys per ring stage,
  stages, O accumulator width) built into a library of their own from
  ``csrc/flash_attention.cu`` with ``ptxas -v`` (registers, spills), each
  held to ``chip_smoke.ATTN_TOL`` against the plain version and timed
  beside SDPA; ``flash --against DIR`` also times DIR's flash kernel (a
  parent checkout unpacked under ``build/``) at the same shapes.
- ``decode`` at the timed decode shapes of ``chip_smoke.DECODE_CASES``,
  bf16: the one-launch kernel's choices (the consumer form -- tensor cores
  or CUDA cores at the GQA pairs --, rows per tile, ring stages) built
  into a library of its own from ``csrc/decode_attention.cu`` with
  ``ptxas -v``, and the default choice at every count of blocks per SM
  its occupancy allows; each held to ``chip_smoke.ATTN_TOL`` against the
  plain version and timed beside SDPA (on a heads-first copy of the valid
  rows) and the bound.  ``decode --against DIR`` also times DIR's decode
  kernel (its own split plan), before and after the choices.  At
  ``long_500k``'s zamba2 shape both kernels also run on the same cache
  laid out heads-first (B x Hkv = 32 sequences of one head), the layout
  question: how much of the gap to SDPA the model's [B, S, Hkv, Dh]
  layout accounts for.

- ``moe_experts`` at mixtral-8x22b's and kimi-k2's routed experts at full
  width, bf16, for the tokens of a call in ``MOE_SHAPES``: mixtral's
  prefill cell (8 experts of D 6,144 / F 16,384, capacity 5,120 slots,
  30,837 filled -- the kept pairs a layer of that cell's traced calls) and
  its steps of 4 to 1,024 tokens, kimi's 4 x 4,096 prefill (384 experts of
  D 7,168 / F 2,048, capacity 426) and its steps, each step's counts from a
  uniform top-k routing: the grouped kernels (one call, both launches) held
  to 2e-2 of each expert's largest value against the padded ``torch.bmm``
  path on the filled slots and timed beside it (the library yardstick, and
  the path a caller would otherwise take), the bound of the filled slots'
  work, and at prefill the plain version on the card.

Each line is one JSON object: device time per call (``torch.profiler``,
summed over the kernel's device functions) and, for the scan, the
CUDA-event time; match-count, decide, window and top-R plans are held
bitwise to their plain versions.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import math
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("kernel_plans: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _build.library()
    print(json.dumps({"card": cs.smi("name,power.limit")}), flush=True)
    gen = torch.Generator(device=dev).manual_seed(5)
    timers = {"rwkv6_scan": rwkv6_plans, "ssd_scan": ssd_plans, "swiglu": swiglu_depths,
              "match_count": match_count_plans, "decide_fused": decide_plans,
              "queue_window": window_plans, "gain_topr": topr_plans,
              "flash": flash_tiles, "decode": decode_plans, "moe_experts": moe_experts_times}
    names = [a for a in sys.argv[1:] if a in timers]
    for name in names or list(timers):
        timers[name](torch, cs, _build, dev, gen)
    return 0


def time_plans(cs, mod, args, want, choices, chosen, kernel, symbols, **kw):
    """Yield (choice, row) for each scan plan in ``choices``: the wrapper
    ``mod.<kernel>`` run with ``mod.plan`` returning that choice, held to
    the plain outputs ``want`` and timed."""
    plan, run = mod.plan, getattr(mod, kernel)
    for choice in choices:
        mod.plan = lambda *_a, _c=choice, **_k: _c
        try:
            o, st = run(*args, **kw)
            ok = (cs.close_err(o, want[0], *cs.SCAN_TOL["bfloat16"])[1]
                  and cs.close_err(st, want[1], *cs.SCAN_TOL["float32"])[1])
            ms = cs.median_ms(lambda: run(*args, **kw), runs=5, inner=3)
            dus = cs.device_us_per_call(lambda: run(*args, **kw), symbols)
        finally:
            mod.plan = plan
        yield choice, {"kernel": kernel, "chosen": choice == chosen, "ok": ok, "ms": ms,
                       "device_us": dus}


def rwkv6_plans(torch, cs, _build, dev, gen):
    from repro_torch.kernels.rwkv6_scan import kernel as rk, ref as rr

    b, s, h, d = cs.SERVE_B, cs.SERVE_S, cs.RWKV_H, cs.RWKV_D
    r, k, v = (torch.randn((b, s, h, d), generator=gen, device=dev).to(torch.bfloat16)
               .transpose(1, 2) for _ in range(3))
    x = torch.rand((b, s, h, d), generator=gen, device=dev) * (math.log(-math.log(0.05))
                                                              - math.log(5e-4))
    lw = (-torch.exp(x + math.log(5e-4))).transpose(1, 2)
    u = torch.rand((h, d), generator=gen, device=dev) * 0.6 - 0.3
    args = (r, k, v, lw, u, torch.randn((b, h, d, d), generator=gen, device=dev))
    want = rr.rwkv6_scan(*args, chunk=32)
    chosen = rk.plan(b, h, d, d, _build.sm_count(0), tensor_cores=True)
    for vb, row in time_plans(cs, rk, args, want, (64, 32, 16, 0), chosen, "rwkv6_scan",
                              cs.LLM_SYMBOLS["rwkv6_scan"], chunk=32):
        print(json.dumps({**row, "columns": vb or "CUDA cores"}), flush=True)


def ssd_plans(torch, cs, _build, dev, gen):
    from repro_torch.kernels.ssd_scan import kernel as sk, ref as sr

    b, s, h, d = cs.SERVE_B, cs.SERVE_S, cs.SSD_H, cs.SSD_D
    x = torch.randn((b, s, h, d), generator=gen, device=dev).to(torch.bfloat16).transpose(1, 2)
    u = torch.rand((b, s, h), generator=gen, device=dev) * (math.log(6.0) - math.log(1e-3))
    a = (-torch.exp(u + math.log(1e-3))).transpose(1, 2)
    bm, cm = (torch.randn((b, s, d), generator=gen, device=dev).to(torch.bfloat16)[:, None]
              .expand(b, h, s, d) for _ in range(2))
    args = (x, a, bm, cm, torch.randn((b, h, d, d), generator=gen, device=dev))
    want = sr.ssd_scan(*args, chunk=64)
    chosen = sk.plan(b, h, d, d, _build.sm_count(0), tensor_cores=True, shared_bc=True)
    for (heads, vb), row in time_plans(cs, sk, args, want,
                                       ((2, 64), (1, 64), (1, 32), (1, 16), (0, None)), chosen,
                                       "ssd_scan", cs.LLM_SYMBOLS["ssd_scan"], chunk=64):
        print(json.dumps({**row, "heads": heads, "columns": vb}), flush=True)


def swiglu_depths(torch, cs, _build, dev, gen):
    from repro_torch.configs import get_config
    from repro_torch.kernels.swiglu import kernel as gk, ref as gr

    chosen = dict(gk.STREAM_WAVES)
    zamba = get_config(cs.ZAMBA, "full")
    zd, zf = zamba.d_model, zamba.d_ff
    for t, dm, f, dtype in ((4, cs.D_MODEL, cs.D_FF, torch.bfloat16),
                            (16, cs.D_MODEL, cs.D_FF, torch.bfloat16),
                            (4, zd, zf, torch.bfloat16), (16, zd, zf, torch.bfloat16),
                            (4, zd, zf, torch.float32)):
        w = [(torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)
             for shape, scale in (((t, dm), 1.0), ((dm, f), dm ** -0.5), ((dm, f), dm ** -0.5),
                                  ((f, dm), f ** -0.5))]
        want = gr.swiglu(*w)
        bf16 = dtype == torch.bfloat16
        row = {"kernel": "swiglu", "T": t, "D": dm, "F": f, "dtype": cs.dtype_name(dtype),
               "plain_device_us": cs.profile_breakdown(lambda: gr.swiglu(*w), calls=10)[1] * 1e3}
        for waves in (2, 4, 8, 16, 32):
            gk.STREAM_WAVES[bf16] = waves
            try:
                ok = cs.close_err(gk.swiglu(*w), want, *cs.SWIGLU_TOL[row["dtype"]])[1]
                dus = cs.device_us_per_call(lambda: gk.swiglu(*w), cs.LLM_SYMBOLS["swiglu"],
                                            calls=10)
            finally:
                gk.STREAM_WAVES.update(chosen)
            row[f"waves_{waves}"] = {"device_us": dus, "ok": ok}
        row["chosen_waves"] = chosen[bf16]
        print(json.dumps(row), flush=True)


def match_count_plans(torch, cs, _build, dev, gen):
    from repro_torch.kernels.l2_match import kernel as lk, ref as lr

    plan = lk.plan
    for m, n, d in ((1024, 1024, 64), (1000, 777, 50)):
        a, b, valid = cs.l2_inputs(torch.Generator().manual_seed(4321), m, n, d, dev)
        want = lr.match_count(a, b, 0.8, valid)
        chosen = plan(d, True)
        for vec in (True, False)[d % 4 != 0:]:
            lk.plan = lambda *_a, _c=vec: _c
            try:
                ok = torch.equal(lk.match_count(a, b, 0.8, valid), want)
                dus = cs.device_us_per_launch(
                    {"match_count_kernel": lambda: lk.match_count(a, b, 0.8, valid)},
                    calls=50)["match_count_kernel"]
            finally:
                lk.plan = plan
            print(json.dumps({"kernel": "match_count", "shape": f"M={m},N={n},D={d}",
                              "copy_bytes": 16 if vec else 4, "chosen": vec == chosen,
                              "bitwise": ok, "device_us": dus}), flush=True)


def decide_plans(torch, cs, _build, dev, gen):
    from repro_torch.kernels.decide_fused import kernel as dk, ref as dr

    plan, k = dk.plan, cs.K_HI
    d = cs.decide_inputs(torch.Generator().manual_seed(1234), cs.MAIN_B, cs.N_OPS, k, dev)
    want = dr.batch_decide(**d, k_hi=k, j_cap=k)
    chosen = plan(cs.N_OPS, k, k)

    def run():
        return dk.batch_decide(**d, k_hi=k, j_cap=k)

    choices = [(w, 32, (2 * k + 1) * 32 * 4) for w in (8, 32, 0)]
    for choice in choices:
        dk.plan = lambda *_a, _c=choice: _c
        try:
            ok = all(torch.equal(g, w) for g, w in zip(run(), want))
            dus = cs.device_us_per_call(run, ("decide_packed_kernel", "decide_fused_kernel"),
                                        calls=20)
        finally:
            dk.plan = plan
        print(json.dumps({"kernel": "decide_fused",
                          "shape": f"B={cs.MAIN_B},N={cs.N_OPS},k_hi={k}",
                          "route": "packed" if choice[0] else "wide", "width": choice[0],
                          "chosen": choice == chosen, "bitwise": ok,
                          "device_us": dus}), flush=True)


def window_plans(torch, cs, _build, dev, gen):
    from repro_torch.kernels.queue_step import kernel as qk, ref as qr

    plan = qk.plan
    args = cs.window_inputs(torch.Generator().manual_seed(99), cs.MAIN_B, cs.N_OPS,
                            cs.WINDOW_STEPS, dev)
    want = qr.queue_window(*args)
    chosen = plan(cs.N_OPS)
    for choice in (("segment", 8), ("segment", 32), ("wide", 32)):
        qk.plan = lambda *_a, _c=choice: _c
        try:
            ok = all(torch.equal(g, w) for g, w in zip(qk.queue_window(*args), want))
            dus = cs.device_us_per_call(lambda: qk.queue_window(*args),
                                        cs.LOOP_SYMBOLS["queue_window"], calls=20)
        finally:
            qk.plan = plan
        print(json.dumps({"kernel": "queue_window",
                          "shape": f"B={cs.MAIN_B},N={cs.N_OPS},steps={cs.WINDOW_STEPS}",
                          "route": choice[0], "width": choice[1], "chosen": choice == chosen,
                          "bitwise": ok, "device_us": dus}), flush=True)


def topr_plans(torch, cs, _build, dev, gen):
    """Each ``gain_topr`` route a shape admits, at the shapes the paths run:
    the two-pass decide's tile (warp route), ``chip_smoke.py``'s N = 40 tile
    and the fleet planner's single scenario of 256 and 1,024 tenants."""
    from repro_torch.kernels.gain_topr import kernel as gk, ref as gr

    plan = gk.plan
    cpu_gen = torch.Generator().manual_seed(1234)
    tiles = [("decide", *cs.gain_topr_inputs(cpu_gen, cs.MAIN_B, cs.N_OPS, cs.K_HI, dev)),
             ("N=40", *cs.gain_topr_inputs(cpu_gen, 256, 40, cs.K_HI, dev))]
    for count in (cs.DISTINCT, 4 * cs.DISTINCT):
        planner, _floors = cs.fleet_planner(count)
        tiles.append((f"fleet-{count}", *cs.fleet_tile(planner, dev)))
    for name, cand, budget in tiles:
        b, n, j = cand.shape
        want = gr.gain_topr(cand, budget)
        chosen = plan(n, j)
        routes = [chosen, ("grid", plan(33, j)[1] if n <= 32 else chosen[1])]
        plain_ms = cs.median_ms(lambda: gr.gain_topr(cand, budget), runs=5, inner=2)
        for choice in dict.fromkeys(routes):
            gk.plan = lambda *_a, _c=choice: _c
            try:
                ok = torch.equal(gk.gain_topr(cand, budget), want)
                ms = cs.median_ms(lambda: gk.gain_topr(cand, budget), runs=15, inner=5)
                dus = cs.device_us_per_call(lambda: gk.gain_topr(cand, budget),
                                            cs.LOOP_SYMBOLS["gain_topr"], calls=20)
            finally:
                gk.plan = plan
            print(json.dumps({"kernel": "gain_topr", "tile": name, "shape": f"B={b},N={n},J={j}",
                              "route": choice[0], "slots": choice[1],
                              "chosen": choice == chosen, "bitwise": ok, "ms": ms,
                              "device_us": dus, "plain_ms": plain_ms,
                              "bound_ms": cs.topr_bound(cand)}), flush=True)


# The bf16 flash kernel's choices at each head dim it serves: (keys per ring
# stage, ring stages, width of the O accumulator); the first of each is the
# one csrc/flash_attention.cu dispatches.  Head dim 112 runs P V at N 112 on
# a V tile whose second 64-column box is half filled, or at N 128 on the
# box's zero-filled columns (dropped at the store).
FLASH_TILES = {64: ((128, 2, 64), (128, 3, 64), (128, 4, 64), (64, 4, 64)),
               112: ((128, 2, 112), (128, 3, 112), (128, 2, 128), (64, 4, 112)),
               128: ((128, 2, 128), (128, 3, 128), (64, 4, 128))}
# (name, head dim, B, Sq, Skv, query heads, KV heads, causal, window): the
# prefill-sized timed flash shapes of chip_smoke.py's FLASH_CASES.
FLASH_SHAPES = (("llama", 64, 4, 4096, 4096, 32, 8, True, None),
                ("whisper_encoder", 64, 16, 1500, 1500, 16, 16, False, None),
                ("zamba2", 112, 4, 4096, 4096, 32, 32, True, None),
                ("kimi", 112, 4, 4096, 4096, 64, 8, True, None),
                ("phi3", 128, 4, 4096, 4096, 40, 10, True, None),
                ("mixtral", 128, 2, 8192, 8192, 48, 8, True, 4096))


def flash_tiles(torch, cs, _build, dev, gen):
    """Every choice of ``FLASH_TILES`` at ``FLASH_SHAPES``, built into a
    library of its own from ``csrc/flash_attention.cu`` with ``ptxas -v``,
    held to ``chip_smoke.ATTN_TOL`` and timed beside the wrapper and SDPA.
    Each ``--against DIR`` also builds DIR's ``src/repro_torch/csrc/
    flash_attention.cu`` (another checkout, e.g. a parent commit unpacked
    under ``build/``) and times its entry point at the same shapes, before
    and after the choices."""
    import ctypes
    import subprocess

    import torch.nn.functional as F

    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels.flash_attention import kernel as fk

    work = ROOT / "build" / "flash_tiles"
    work.mkdir(parents=True, exist_ok=True)
    # the strides as plain integers: a signature naming the source's
    # internal Strides type would give the entry point internal linkage
    args = ("const void* q, const void* k, const void* v, void* o, long long qb, long long qh, "
            "long long qs, long long kb, long long kh, long long ks, long long vb, "
            "long long vh, long long vs, long long ob, long long oh, long long os, int b, int h, "
            "int hkv, int sq, int skv, float scale, int causal, int window, int device, "
            "void* stream")
    call = ("q, k, v, o, Strides{qb, qh, qs}, Strides{kb, kh, ks}, Strides{vb, vh, vs}, "
            "Strides{ob, oh, os}, b, h, hkv, sq, skv, scale, causal, window, device, "
            "static_cast<cudaStream_t>(stream)")
    src = ['#include "flash_attention.cu"', f"extern \"C\" int flash_tile(int i, {args}) {{"]
    index = {}
    for dh, tiles in FLASH_TILES.items():
        for tile in tiles:
            index[dh, *tile] = len(index)
            targs = ", ".join(str(x) for x in (dh, *tile))
            src.append(f"  if (i == {len(index) - 1}) return launch_wgmma<{targs}>({call});")
    src.append("  return cudaErrorInvalidValue;\n}")
    (work / "tiles.cu").write_text("\n".join(src) + "\n")
    builds = [("tiles", work / "tiles.cu", _build.CSRC)]
    trees = [pathlib.Path(sys.argv[i + 1]).resolve() for i, a in enumerate(sys.argv)
             if a == "--against"]
    for n, tree in enumerate(trees):
        csrc = tree / "src" / "repro_torch" / "csrc"
        builds.append((f"against{n}", csrc / "flash_attention.cu", csrc))
    libs = {}
    for name, path, inc in builds:
        lib_path = work / f"lib{name}.so"
        res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas=-v", "-shared",
                              "-I", str(inc), str(path), "-o", str(lib_path)],
                             capture_output=True, text=True)
        ptxas = [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
                 if "entry function" in ln or "registers" in ln or "spill" in ln
                 or "error" in ln or "warning" in ln or "Performance" in ln]
        print(json.dumps({"kernel": "flash_attention", "build": name, "source": str(path),
                          "build_rc": res.returncode, "ptxas": ptxas}), flush=True)
        if res.returncode:
            return
        libs[name] = ctypes.CDLL(str(lib_path))
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    tile_fn = libs["tiles"].flash_tile
    tile_fn.argtypes = [i] + [p] * 4 + [ll] * 12 + [i] * 5 + [f] + [i] * 3 + [p]
    tile_fn.restype = i
    others = []  # (tree, its entry point)
    for n, tree in enumerate(trees):
        fn = libs[f"against{n}"].repro_flash_attention
        fn.argtypes = [p] * 4 + [ll] * 12 + [i] * 6 + [f] + [i] * 4 + [p]
        fn.restype = i
        others.append((tree, fn))
    symbols = ("flash_wgmma_kernel", "flash_mma_kernel")  # this tree's, the parent's

    for name, dh, b, sq, skv, hq, hkv, causal, window in FLASH_SHAPES:
        q = torch.randn((b, sq, hq, dh), generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn((b, skv, hkv, dh), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # the model's [B, S, H, Dh]
        want = cs._plain_attention(q, k, v, causal=causal, window=window)
        bound = cs.bound(*kcost.flash_work(b, hq, hkv, sq, skv, dh, causal=causal,
                                           window=window), cs.PEAK_BF16_OPS_PER_S)[0]
        shape = f"{name}: B={b},Sq={sq},Skv={skv},H={hq}/{hkv},Dh={dh}" + (
            f",window={window}" if window else ",causal" if causal else ",bidirectional")

        def run(fn, *lead):
            out = torch.empty((b, sq, hq, dh), dtype=q.dtype, device=dev).transpose(1, 2)
            st = [t.stride(j) for t in (q, k, v, out) for j in (0, 1, 2)]
            other = fn is not tile_fn  # another tree's entry: head dim and dtype flag too
            code = fn(*lead, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *st, b,
                      hq, hkv, sq, skv, *((dh,) if other else ()), dh ** -0.5, int(causal),
                      window or 0, *((1,) if other else ()), *_build.launch_args(q))
            _build.check_error("flash_tile", code)
            return out

        def timed(fn, label, **extra):
            ok = cs.close_err(fn(), want, *cs.ATTN_TOL["bfloat16"])[1]
            print(json.dumps({"kernel": "flash_attention", "shape": shape, **extra, "ok": ok,
                              "ms": cs.median_ms(fn, runs=5, inner=3),
                              "device_us": cs.device_us_per_call(fn, symbols),
                              "bound_ms": bound, "run": label}), flush=True)

        for tree, fn in others:
            timed(lambda fn=fn: run(fn), "against", tree=str(tree))
        for tile in FLASH_TILES[dh]:
            idx = index[(dh, *tile)]
            timed(lambda idx=idx: run(tile_fn, idx), "tile",
                  tile=dict(zip(("keys", "stages", "acc_cols"), tile)),
                  chosen=tile == FLASH_TILES[dh][0])
        for tree, fn in others:
            timed(lambda fn=fn: run(fn), "against", tree=str(tree))
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                      enable_gqa=True)
        wrapper = lambda: fk.attention(q, k, v, causal=causal, window=window)
        print(json.dumps({"kernel": "flash_attention", "shape": shape, "run": "wrapper",
                          "ms": cs.median_ms(wrapper, runs=5, inner=3),
                          "sdpa_ms": None if window else cs.median_ms(sdpa, runs=5, inner=3),
                          "bound_ms": bound}), flush=True)
        del q, k, v, want
        torch.cuda.empty_cache()


# The decode kernel's choices per (head dim, query heads per KV head):
# (form, rows per tile, ring stages); the first of each is csrc/
# decode_attention.cu's `Plan`, timed at every count of blocks per SM its
# occupancy allows (the wrapper runs ``BLOCKS_PER_SM``), the others at
# their most.  "mma": `MmaTile` (tensor cores, bf16 GQA); "core":
# `CoreTile` (CUDA cores), "pair" its MHA form over two heads a group;
# "loads": the first with no arithmetic.
DECODE_CHOICES = {
    **{(dh, r): (("mma", 64, 4), ("mma", 64, 2), ("mma", 64, 3), ("mma", 128, 2), ("core", 64, 4),
                 ("loads", 64, 4))
       for dh, r in ((64, 4), (112, 8), (128, 4), (128, 6), (128, 7), (128, 8))},
    **{(dh, 1): (("pair", 32, 4), ("pair", 32, 2), ("pair", 64, 2), ("core", 64, 4),
                 ("core", 64, 2), ("core", 128, 2), ("loads", 32, 4)) for dh in (64, 112)},
}
# (name, head dim, query heads, KV heads, B, S_max, length, window): the
# timed bf16 decode shapes of chip_smoke.py's DECODE_CASES.
DECODE_SHAPES = (("llama_32k", 64, 32, 8, 16, 32768, 32000, None),
                 ("llama_step", 64, 32, 8, 4, 4128, 4097, None),
                 ("zamba2_step", 112, 32, 32, 4, 4128, 4097, None),
                 ("phi3_step", 128, 40, 10, 4, 4128, 4097, None),
                 ("yi_step", 128, 56, 8, 4, 4128, 4097, None),
                 ("command_r_step", 128, 64, 8, 4, 4128, 4097, None),
                 ("phi3_32k", 128, 40, 10, 16, 32768, 32000, None),
                 ("mixtral_step", 128, 48, 8, 4, 4128, 4097, 4096),
                 ("kimi_step", 112, 64, 8, 4, 4128, 4097, None),
                 ("whisper_cross", 64, 16, 16, 16, 1500, 1500, None),
                 ("whisper_self", 64, 16, 16, 16, 448, 225, None),
                 ("zamba2_long_500k", 112, 32, 32, 1, 524288, 524288, None),
                 ("mixtral_long_500k", 128, 48, 8, 1, 524288, 524288, 4096))


def decode_plans(torch, cs, _build, dev, gen):
    """Every choice of ``DECODE_CHOICES`` at ``DECODE_SHAPES``, built into a
    library of its own with ``ptxas -v``, held to ``chip_smoke.ATTN_TOL``
    and timed beside SDPA, the bound and, with ``--against DIR``, DIR's
    decode kernel; then the heads-first layout at ``long_500k``."""
    import ctypes
    import subprocess

    import torch.nn.functional as F

    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels.decode_attention import kernel as dk, ref as dr

    work = ROOT / "build" / "decode_plans"
    work.mkdir(parents=True, exist_ok=True)
    args = ("const void* q, const void* k, const void* v, const int* len, void* o, float* part, "
            "unsigned* count, int b, int hkv, int s_max, int grid, float scale, int window, "
            "int device, void* stream")
    # "loads": the default choice with its arithmetic taken out (the TMA
    # ring, the masks' loop and the merges stay): the time the ring alone
    # needs, so the consumers' share of the kernel's time (its output is
    # wrong and is not held to the plain version).
    src = ['#include "decode_attention.cu"',
           "template <class C> struct LoadsOnly : C {",
           "  using C::C;",
           "  __device__ void tile(const uint8_t*, int, int, bool) {}",
           "};",
           f"extern \"C\" int decode_plan(int i, {args}) {{",
           "  const Args a{q, k, v, len, o, part, count, b, s_max, hkv, grid, scale, window};",
           "  cudaStream_t s = static_cast<cudaStream_t>(stream);"]
    per_sm = ["extern \"C\" int decode_plan_per_sm(int i, int device, int* n) {"]
    index = {}
    for (dh, r), choices in DECODE_CHOICES.items():
        for form, tile, stages in choices:
            index[dh, r, form, tile, stages] = i = len(index)
            insts = {"mma": f"MmaTile<{dh}, {r}, {tile}, {stages}>",
                     "core": f"CoreTile<bf16, {dh}, {r}, {tile}, {stages}>",
                     "pair": f"CoreTile<bf16, {dh}, 2, {tile}, {stages}, 2>"}
            inst = insts.get(form) or f"LoadsOnly<{insts[choices[0][0]]}>"
            src.append(f"  if (i == {i}) return launch<{inst}>(a, device, s);")
            per_sm.append(f"  if (i == {i}) return occupancy<{inst}>(device, n);")
    src += ["  return cudaErrorInvalidValue;\n}", *per_sm, "  return cudaErrorInvalidValue;\n}"]
    (work / "plans.cu").write_text("\n".join(src) + "\n")
    builds = [("plans", work / "plans.cu", _build.CSRC)]
    trees = [pathlib.Path(sys.argv[i + 1]).resolve() for i, a in enumerate(sys.argv)
             if a == "--against"]
    for n, tree in enumerate(trees):
        csrc = tree / "src" / "repro_torch" / "csrc"
        builds.append((f"against{n}", csrc / "decode_attention.cu", csrc))
    libs = {}
    for name, path, inc in builds:
        lib_path = work / f"lib{name}.so"
        res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas=-v", "-shared",
                              "-I", str(inc), str(path), "-o", str(lib_path)],
                             capture_output=True, text=True)
        lines = (res.stdout + res.stderr).splitlines()
        ptxas, entry, spill = [], None, None  # (entry, spill line, registers line)
        for ln in lines:
            if "Compiling entry function" in ln:
                entry, spill = ln.split("'")[1], None
            elif "spill stores" in ln:
                spill = ln.strip()
            elif "registers" in ln and entry and "decode" in entry:
                ptxas.append([entry, spill, ln.split(":", 1)[-1].strip()])
        print(json.dumps({"kernel": "decode_attention", "build": name, "source": str(path),
                          "build_rc": res.returncode, "ptxas": ptxas,
                          "errors": [ln for ln in lines if "error" in ln][:20]}), flush=True)
        if res.returncode:
            return
        libs[name] = ctypes.CDLL(str(lib_path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    plan_fn, plan_per_sm = libs["plans"].decode_plan, libs["plans"].decode_plan_per_sm
    plan_fn.argtypes = [i] + [p] * 7 + [i] * 4 + [f] + [i] * 2 + [p]
    plan_fn.restype = i
    plan_per_sm.argtypes = [i, i, ctypes.POINTER(i)]
    plan_per_sm.restype = i
    others = []
    for n, tree in enumerate(trees):
        lib = libs[f"against{n}"]
        lib.repro_decode_attention.argtypes = [p] * 7 + [i] * 6 + [f] + [i] * 3 + [p]
        lib.repro_decode_attention.restype = i
        lib.repro_decode_attention_blocks_per_sm.argtypes = [i] * 4 + [ctypes.POINTER(i)]
        lib.repro_decode_attention_blocks_per_sm.restype = i
        others.append((tree, lib))
    symbols = ("decode_tma_kernel", "decode_split_kernel", "decode_combine_kernel")
    sms = _build.sm_count(0)
    bf16 = torch.bfloat16

    def blocks_per_sm(idx):
        n = ctypes.c_int(0)
        _build.check_error("decode_plan", plan_per_sm(idx, 0, ctypes.byref(n)))
        return n.value

    def parent_call(lib, q, k, v, n, window):
        b, h, dh = q.shape
        s_max, hkv = k.shape[1], k.shape[2]
        per = ctypes.c_int(0)
        _build.check_error("against", lib.repro_decode_attention_blocks_per_sm(
            dh, h // hkv, 1, 0, ctypes.byref(per)))
        splits = max(1, min(per.value * sms // (b * hkv), s_max // 256, 64))  # its split_plan
        ws = torch.empty(b * h * splits * (dh + 2), dtype=torch.float32, device=dev)
        out = torch.empty_like(q)

        def run():
            _build.check_error("against", lib.repro_decode_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), n.data_ptr(), out.data_ptr(),
                ws.data_ptr(), ws.data_ptr() + b * h * splits * dh * 4, b, h, hkv, s_max, dh,
                splits, dh ** -0.5, window or 0, 1, 0, torch.cuda.current_stream().cuda_stream))
            return out
        return run

    def plan_call(idx, grid, q, k, v, n, window):
        b, h, dh = q.shape
        s_max, hkv = k.shape[1], k.shape[2]
        out = torch.empty_like(q)
        part = torch.empty(2 * grid * max(h // hkv, 2) * (dh + 2), dtype=torch.float32,
                           device=dev)
        count = torch.zeros(b * hkv, dtype=torch.int32, device=dev)

        def run():
            _build.check_error("decode_plan", plan_fn(
                idx, q.data_ptr(), k.data_ptr(), v.data_ptr(), n.data_ptr(), out.data_ptr(),
                part.data_ptr(), count.data_ptr(), b, hkv, s_max, grid, dh ** -0.5, window or 0,
                0, torch.cuda.current_stream().cuda_stream))
            return out
        return run

    def timed(fn, want, label, shape, bound, **extra):
        got = fn().clone()
        ok = cs.close_err(got, want, *cs.ATTN_TOL["bfloat16"])[1] and torch.equal(fn(), got)
        print(json.dumps({"kernel": "decode_attention", "shape": shape, "run": label, **extra,
                          "ok": ok, "ms": cs.median_ms(fn, runs=5, inner=3),
                          "device_us": cs.device_us_per_call(fn, symbols), "bound_ms": bound}),
              flush=True)

    def against(q, k, v, n, window, want, shape, bound):
        for tree, lib in others:
            timed(parent_call(lib, q, k, v, n, window), want, "against", shape, bound,
                  tree=str(tree))

    for name, dh, hq, hkv, b, s_max, length, window in DECODE_SHAPES:
        q = torch.randn((b, hq, dh), generator=gen, device=dev).to(bf16)
        k, v = (torch.randn((b, s_max, hkv, dh), generator=gen, device=dev).to(bf16)
                for _ in range(2))
        n = torch.tensor(length, dtype=torch.int32, device=dev)
        want = dr.decode_attention(q, k, v, n, window=window)
        lo = max(0, length - window) if window else 0
        bound = cs.bound(*kcost.decode_work(b, hq, hkv, dh, length - lo),
                         cs.PEAK_BF16_OPS_PER_S)[0]
        shape = f"{name}: B={b},S_max={s_max},length={length},H={hq}/{hkv},Dh={dh}" + (
            f",window={window}" if window else "")
        against(q, k, v, n, window, want, shape, bound)
        choices = DECODE_CHOICES[dh, hq // hkv]
        for choice in choices:
            idx = index[(dh, hq // hkv, *choice)]
            most = blocks_per_sm(idx)
            for per in range(1, most + 1) if choice == choices[0] else (most,):
                timed(plan_call(idx, per * sms, q, k, v, n, window), want, "plan", shape, bound,
                      form=choice[0], tile=choice[1], stages=choice[2], blocks_per_sm=per,
                      chosen=choice == choices[0] and per == dk.BLOCKS_PER_SM)
        against(q, k, v, n, window, want, shape, bound)
        kv = [t[:, lo:length].transpose(1, 2).contiguous() for t in (k, v)]
        print(json.dumps({"kernel": "decode_attention", "shape": shape, "run": "wrapper",
                          "ms": cs.median_ms(lambda: dk.decode_attention(q, k, v, n,
                                                                          window=window),
                                             runs=5, inner=3),
                          "sdpa_ms": cs.median_ms(lambda: F.scaled_dot_product_attention(
                              q[:, :, None], *kv, enable_gqa=True), runs=5, inner=3),
                          "bound_ms": bound}), flush=True)
        del kv
        if name == "zamba2_long_500k":  # the same bytes, heads-first: 32 sequences of one head
            qh, kh, vh = (t.transpose(1, 2).reshape(b * hkv, 1, -1, dh).transpose(1, 2)
                          .contiguous() for t in (q[:, None], k, v))
            qh = qh[:, 0]
            want_h = want.reshape(b * hkv, 1, dh)
            single = ("core", 64, 4)  # one head a sequence: the wrapper's single-head route
            idx = index[(dh, 1, *single)]
            layout = f"{name} heads-first: B={b * hkv},S_max={s_max},length={length},H=1/1,Dh={dh}"
            against(qh, kh, vh, n, window, want_h, layout, bound)
            timed(plan_call(idx, dk.BLOCKS_PER_SM * sms, qh, kh, vh, n, window), want_h, "plan",
                  layout, bound, form=single[0], tile=single[1], stages=single[2],
                  blocks_per_sm=dk.BLOCKS_PER_SM, chosen=True)
            against(qh, kh, vh, n, window, want_h, layout, bound)
            del qh, kh, vh
        del q, k, v, want
        torch.cuda.empty_cache()


# (arch, tokens a call) of the routed experts: mixtral's prefill cell (its
# measured counts, ``chip_smoke.MOE_COUNTS``) and calls of 4 to 1,024
# tokens (capacity 1 to 320 slots, across one and two row tiles: the data
# behind ``MIN_SLOTS``), kimi's 4 x 4,096 prefill (capacity 426) and calls
# of 4 to 5,120 tokens (capacity 1 to 133).
MOE_SHAPES = (("mixtral-8x22b", (16384, 4, 16, 64, 256, 384, 416, 512, 1024)),
              ("kimi-k2-1t-a32b", (16384, 4, 256, 1024, 4096, 5120)))


def moe_experts_times(torch, cs, _build, dev, gen):
    from repro_torch.configs import get_config
    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels.moe_experts import kernel as mk, ref as mr
    from repro_torch.models import ffn

    for arch, tokens in MOE_SHAPES:
        cfg = get_config(arch, "full")
        e, d, f, k = cfg.n_experts, cfg.d_model, cfg.expert_ff, cfg.top_k
        wg, wu = ((torch.randn(e, d, f, generator=gen, device=dev) * d ** -0.5)
                  .to(torch.bfloat16) for _ in range(2))
        wo = (torch.randn(e, f, d, generator=gen, device=dev) * f ** -0.5).to(torch.bfloat16)
        for t in tokens:
            cap = ffn.moe_capacity(cfg, t)
            if arch == "mixtral-8x22b" and t == 16384:
                counts = torch.tensor(cs.MOE_COUNTS, dtype=torch.int32, device=dev)
            else:  # each token's top-k of uniform scores: uniform routing
                pick = torch.rand(t, e, generator=gen, device=dev).topk(k).indices
                counts = pick.flatten().bincount(minlength=e).clamp(max=cap).to(torch.int32)
            buf = torch.randn(e, cap, d, generator=gen, device=dev).to(torch.bfloat16)
            buf[torch.arange(cap, device=dev)[None, :] >= counts[:, None]] = 0
            args = (buf, wg, wu, wo)
            big = t >= 4096
            kw = dict(runs=5, inner=3) if big else dict(runs=15, inner=10)
            with torch.no_grad():
                got, want = mk.experts(*args, counts), ffn._experts(*args)
                n = counts.tolist()
                err = max((float((got[i, :c].float() - want[i, :c].float()).abs().max())
                           / float(want[i, :c].float().abs().max()) for i, c in enumerate(n)
                           if c), default=0.0)
                del got, want
                row = {"kernel": "moe_experts", "arch": arch, "tokens": t, "E": e, "C": cap,
                       "D": d, "F": f, "filled": sum(n), "experts_filled": sum(map(bool, n)),
                       "rows_run": int(mk.run_rows(counts, cap).sum()), "max_rel_err": err,
                       "ok": err <= 2e-2,
                       "ms": cs.median_ms(lambda: mk.experts(*args, counts), **kw),
                       "bmm_ms": cs.median_ms(lambda: ffn._experts(*args), **kw),
                       "bound_ms": cs.bound(*kcost.moe_experts_work(n, d, f),
                                            cs.PEAK_BF16_OPS_PER_S)}
                row["kernel_over_bmm"] = row["ms"] / row["bmm_ms"]
                if big:
                    row["device_us"] = cs.device_us_per_call(
                        lambda: mk.experts(*args, counts), ("experts_wgmma_kernel",), calls=3)
                    row["plain_ms"] = cs.median_ms(lambda: mr.experts(*args, counts),
                                                   runs=3, inner=1)
            print(json.dumps(row), flush=True)
            del buf, args
            torch.cuda.empty_cache()
        del wg, wu, wo
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
