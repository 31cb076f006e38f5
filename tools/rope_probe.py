#!/usr/bin/env python3
"""RoPE at ``long_500k``'s last positions on one CUDA card against the CPU:
the reading behind ``models/common.py:rope_frequencies`` building its table
on the CPU for every device.

    python3 tools/rope_probe.py

For each (head dim, base) of llama3.2-1b, zamba2-7b and mixtral-8x22b and
the smoke configs' (16, 10,000), one JSON line: the entries of the float32
frequency table ``1 / theta ** (arange(0, dh, 2) / dh)`` computed on the
card (as the port did before) that differ from the CPU's (and how many of
each differ from the float64 table rounded once); the largest error of the card's and the
CPU's float32 ``cos`` / ``sin`` of the same float32 angles at positions
524,224-524,287 against float64; and ``apply_rope``'s largest card vs CPU
difference there (standard normal x) with the table computed on the card,
as the port did before, and with the port's own table.
"""

from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
CASES = ((64, 500000.0), (112, 10000.0), (128, 1e6), (16, 10000.0))
POSITIONS = (524_224, 524_288)


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.models import common

    if not torch.cuda.is_available():
        print("rope_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda, flush=True)
    for dh, theta in CASES:
        exps = torch.arange(0, dh, 2, dtype=torch.float32) / dh
        cpu = 1.0 / (theta ** exps)
        card_exps = torch.arange(0, dh, 2, dtype=torch.float32, device=dev) / dh
        card = (1.0 / (theta ** card_exps)).cpu()  # the table the port built on the card before
        exact = (1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float64) / dh))).float()
        pos = torch.arange(*POSITIONS)[None]
        angles = pos[..., None].float() * cpu
        trig = {}
        for name, fn in (("cos", torch.cos), ("sin", torch.sin)):
            want = fn(angles.double())
            trig[name] = {"card": float((fn(angles.to(dev)).cpu().double() - want).abs().max()),
                          "cpu": float((fn(angles).double() - want).abs().max())}
        x = torch.randn((1, POSITIONS[1] - POSITIONS[0], 2, dh),
                        generator=torch.Generator().manual_seed(dh))
        want = common.apply_rope(x, pos, theta)
        ported = common.apply_rope(x.to(dev), pos.to(dev), theta).cpu()
        xd, pd = x.to(dev), pos.to(dev)
        ang = pd[..., None].float() * card.to(dev)
        cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
        x1, x2 = torch.chunk(xd, 2, dim=-1)
        card_table = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).cpu()
        print(json.dumps({
            "head_dim": dh, "theta": theta,
            "table_entries_card_not_cpu": (card != cpu).nonzero().flatten().tolist(),
            "card_not_float64_rounded": int((card != exact).sum()),
            "cpu_not_float64_rounded": int((cpu != exact).sum()),
            "trig_max_err_vs_float64": trig, "x_max": float(x.abs().max()),
            "apply_rope_card_vs_cpu_card_table": float((card_table - want).abs().max()),
            "apply_rope_card_vs_cpu_port": float((ported - want).abs().max()),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
