"""The paper's VLD application end to end on the port's live stream
engine, with the DRS scheduler closing the loop: measure -> model ->
rebalance.  Extract and match run on the card (``match_count`` is the
CUDA kernel) unless ``--device cpu`` runs their plain versions.

Frames flow through extract -> match -> aggregate while a deliberately
bad allocation starves the extractor; after a measurement window the
session's tick() recommends and applies the optimal allocation.

    PYTHONPATH=src python examples/stream_vld_torch.py              # on the card
    PYTHONPATH=src python examples/stream_vld_torch.py --device cpu
"""

import argparse
import time

import numpy as np

from repro_torch.api import SchedulerConfig
from repro_torch.streaming.apps.vld import VLDConfig, build_vld_graph, logo_library, make_frame

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
device = ap.parse_args().device

cfg = VLDConfig(height=80, width=80, max_keypoints=24, n_logos=8)
lib = logo_library(cfg)
graph, detections = build_vld_graph(cfg, lib, device=device)

session = graph.bind(
    "engine",
    config=SchedulerConfig(k_max=6, min_improvement=0.01, horizon_seconds=600.0),
    device=device,
)

bad = {"extract": 1, "match": 2, "aggregate": 1}
print(f"[1] starting with a deliberately bad allocation: {bad}")
session.start(bad)

rng = np.random.default_rng(0)
t_end = time.time() + 6.0
sent = 0
while time.time() < t_end:
    session.inject(make_frame(cfg, rng, np.asarray(lib), rng.random() < 0.4))
    sent += 1
    time.sleep(0.004)

decision = session.tick()  # pull -> model -> decide -> apply (if worthwhile)
print(f"[2] after {sent} frames DRS says: action={decision.action} "
      f"k_target={None if decision.k_target is None else decision.k_target.tolist()}")
if decision.action == "rebalance":
    print(f"[3] rebalance applied -> {session.allocation}")
elif decision.action == "overloaded":
    print(f"[3] measured rho >= 1 (starved extractor saturated): overload "
          f"scale-out applied immediately -> {session.allocation}")
else:
    print("[3] DRS judges the current allocation adequate (cost/benefit or "
          "<min_improvement): a valid outcome; no disruption incurred")

t_end = time.time() + 4.0
while time.time() < t_end:
    session.inject(make_frame(cfg, rng, np.asarray(lib), rng.random() < 0.4))
    time.sleep(0.02)

session.drain(timeout=30.0)
session.stop()
lat = np.array(session.completed_sojourns)
print(f"[4] processed {len(detections)} frames on {device}; "
      f"mean sojourn {lat.mean()*1e3:.1f} ms, p95 {np.percentile(lat, 95)*1e3:.1f} ms")
print(f"    detections fired on {int(sum(d.any() for d in detections))} frames")
