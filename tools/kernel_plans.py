#!/usr/bin/env python3
"""Time the launch plans of the port's SwiGLU and SSD-scan kernels on one
CUDA card, at the serving shapes, to choose their constants.

    python3 tools/kernel_plans.py        # from the repository root

- ``ssd_scan`` at zamba2-7b's prefill (4 x 4096, 112 heads x 64, state
  64, chunk 64, B / C shared by the heads), bf16: every tensor-core plan
  (heads per block, columns per block) and the CUDA-core kernel, each
  held to ``chip_smoke.SCAN_TOL`` against the plain version;
- ``swiglu`` at the decode shapes (llama3.2-1b and zamba2-7b widths, T 4
  and 16; bf16, and float32 at T 4): the weight-streaming split depth
  ``kernel.STREAM_WAVES`` from 2 to 32 blocks per SM.

Each line is one JSON object: device time per call (``torch.profiler``,
summed over the kernel's device functions) and, for the scan, the
CUDA-event time.  Exits non-zero without a CUDA device.
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
    from repro_torch.kernels.ssd_scan import kernel as sk, ref as sr
    from repro_torch.kernels.swiglu import kernel as gk, ref as gr

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _build.library()
    print(json.dumps({"card": cs.smi("name,power.limit")}), flush=True)
    gen = torch.Generator(device=dev).manual_seed(5)

    b, s, h, d = cs.SERVE_B, cs.SERVE_S, cs.SSD_H, cs.SSD_D
    x = torch.randn((b, s, h, d), generator=gen, device=dev).to(torch.bfloat16).transpose(1, 2)
    u = torch.rand((b, s, h), generator=gen, device=dev) * (math.log(6.0) - math.log(1e-3))
    a = (-torch.exp(u + math.log(1e-3))).transpose(1, 2)
    bm, cm = (torch.randn((b, s, d), generator=gen, device=dev).to(torch.bfloat16)[:, None]
              .expand(b, h, s, d) for _ in range(2))
    args = (x, a, bm, cm, torch.randn((b, h, d, d), generator=gen, device=dev))
    py, pst = sr.ssd_scan(*args, chunk=64)
    chosen = sk.plan
    for choice in ((2, 64), (1, 64), (1, 32), (1, 16), (0, None)):
        sk.plan = lambda *_a, _c=choice, **_k: _c
        try:
            y, st = sk.ssd_scan(*args, chunk=64)
            ok = (cs.close_err(y, py, *cs.SCAN_TOL["bfloat16"])[1]
                  and cs.close_err(st, pst, *cs.SCAN_TOL["float32"])[1])
            ms = cs.median_ms(lambda: sk.ssd_scan(*args, chunk=64), runs=5, inner=3)
            dus = cs.device_us_per_call(lambda: sk.ssd_scan(*args, chunk=64),
                                        cs.LLM_SYMBOLS["ssd_scan"])
        finally:
            sk.plan = chosen
        print(json.dumps({"kernel": "ssd_scan", "heads": choice[0], "columns": choice[1],
                          "chosen": choice == chosen(b, h, d, d, _build.sm_count(0),
                                                     tensor_cores=True, shared_bc=True),
                          "ok": ok, "ms": ms, "device_us": dus}), flush=True)
    del x, a, bm, cm, args, py, pst

    chosen = dict(gk.STREAM_WAVES)
    for t, dm, f, dtype in ((4, cs.D_MODEL, cs.D_FF, torch.bfloat16),
                            (16, cs.D_MODEL, cs.D_FF, torch.bfloat16),
                            (4, cs.ZAMBA_D, cs.ZAMBA_F, torch.bfloat16),
                            (16, cs.ZAMBA_D, cs.ZAMBA_F, torch.bfloat16),
                            (4, cs.ZAMBA_D, cs.ZAMBA_F, torch.float32)):
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
