#!/usr/bin/env python3
"""Time the launch plans of the port's SwiGLU, scan, match-count and fused
decide kernels on one CUDA card, at their paths' shapes, to choose their
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
- ``flash_dh128`` at phi3-medium-14b's prefill (4 x 4096, 40 / 10 heads
  of 128, causal), bf16: the tensor-core kernel's tiles (warps x row
  tiles x keys per stage) built into a library of their own from
  ``csrc/flash_attention.cu`` with ``ptxas -v`` (registers, spills), each
  held to ``chip_smoke.ATTN_TOL`` against the plain version and timed.

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
              "flash_dh128": flash_dh128_tiles}
    for name in sys.argv[1:] or list(timers):
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


# (warps, row tiles per warp, keys per stage) of the head-dim-128 tile; the
# first is the one csrc/flash_attention.cu dispatches.
FLASH128_TILES = ((4, 1, 64), (4, 1, 32), (8, 1, 32), (8, 1, 64))


def flash_dh128_tiles(torch, cs, _build, dev, gen):
    import ctypes
    import subprocess

    from repro_torch.kernels.flash_attention import kernel as fk, ref as fr

    work = ROOT / "build" / "flash_dh128_tiles"
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
    src = ['#include "flash_attention.cu"', f"extern \"C\" int flash128_tile(int i, {args}) {{"]
    for i, (w, mt, bkv) in enumerate(FLASH128_TILES):
        src.append(f"  if (i == {i}) return launch_mma<128, {w}, {mt}, {bkv}>({call});")
    src.append("  return cudaErrorInvalidValue;\n}")
    (work / "tiles.cu").write_text("\n".join(src) + "\n")
    lib_path = work / "libtiles.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas=-v", "-shared",
                          "-I", str(_build.CSRC), str(work / "tiles.cu"), "-o", str(lib_path)],
                         capture_output=True, text=True)
    ptxas = [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
             if "entry function" in ln or "registers" in ln or "spill" in ln or "error" in ln]
    print(json.dumps({"kernel": "flash_attention", "build_rc": res.returncode,
                      "ptxas": ptxas}), flush=True)
    if res.returncode:
        return

    lib = ctypes.CDLL(str(lib_path))
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.flash128_tile.argtypes = [i] + [p] * 4 + [ll] * 12 + [i] * 5 + [f] + [i] * 3 + [p]
    lib.flash128_tile.restype = i
    b, s, hq, hkv, dh = cs.SERVE_B, cs.SERVE_S, 40, 10, 128
    q, k, v = (torch.randn((b, s, n, dh), generator=gen, device=dev).to(torch.bfloat16)
               .transpose(1, 2) for n in (hq, hkv, hkv))
    want = fr.attention(q, k, v)
    nbytes = 2 * b * s * dh * (2 * hq + 2 * hkv)
    bound = cs.bound(nbytes, 4 * dh * b * hq * s * (s + 1) // 2, cs.PEAK_BF16_OPS_PER_S)

    def run(idx):
        out = torch.empty((b, s, hq, dh), dtype=q.dtype, device=dev).transpose(1, 2)
        st = [t.stride(j) for t in (q, k, v, out) for j in (0, 1, 2)]
        code = lib.flash128_tile(idx, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 out.data_ptr(), *st, b, hq, hkv, s, s, dh ** -0.5, 1, 0,
                                 *_build.launch_args(q))
        _build.check_error("flash128_tile", code)
        return out

    for idx, tile in enumerate(FLASH128_TILES):
        ok = cs.close_err(run(idx), want, *cs.ATTN_TOL["bfloat16"])[1]
        print(json.dumps({"kernel": "flash_attention", "tile": dict(zip(
            ("warps", "row_tiles", "keys"), tile)), "chosen": idx == 0, "ok": ok,
            "ms": cs.median_ms(lambda idx=idx: run(idx), runs=5, inner=3),
            "wrapper_ms": cs.median_ms(lambda: fk.attention(q, k, v), runs=5, inner=3),
            "bound_ms": bound[0]}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
