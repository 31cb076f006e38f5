"""Quickstart on the PyTorch port: declare the app graph once, model and
simulate through it.

The paper's core loop on the VLD-like topology (paper §V): declare the
operators as an AppGraph (``repro_torch.api``), ask Program (4) where
processors should go and Program (6) how many a latency SLO needs, and
check both against the discrete-event simulation, all through the same
graph.  The candidate allocations are priced once more on the device with
``expected_sojourn_batch`` (one ``erlang_c`` kernel launch on a card).

    PYTHONPATH=src python examples/quickstart_torch.py              # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""

import argparse

import numpy as np

from repro_torch.api import AppGraph
from repro_torch.core.batched import expected_sojourn_batch

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
device = ap.parse_args().device

# --- the application: spout -> extract -> match -> aggregate ----------- #
# 13 frames/s arrive; one processor extracts 2 frames/s, matches 5
# feature-sets/s, aggregates 50 match-sets/s (paper §V-B scale).
graph = AppGraph.chain([("extract", 2.0), ("match", 5.0), ("agg", 50.0)], lam0=13.0)
top = graph.topology()

print("traffic (lambda_i):", top.arrival_rates)
print("minimum feasible allocation:", top.min_feasible_allocation())

# --- Program (4): best placement of 22 executors ----------------------- #
session = graph.bind("des", horizon=400.0, warmup=40.0)
best = session.plan(k_max=22)
print(f"\nProgram (4) @ K=22  ->  k = {best.k.tolist()}  "
      f"E[T] = {best.expected_sojourn:.3f}s")

# the neighbouring configurations of the paper's Fig. 6, priced on the
# device in one batch (float32) beside the float64 model and the DES
cands = [[8, 12, 2], [12, 8, 2], [7, 13, 2], best.k.tolist()]
on_device = expected_sojourn_batch(top, np.array(cands), device=device)
for cand, dev_t in zip(cands, on_device):
    model_t = top.expected_sojourn(cand)
    sim = session.simulate(cand, seed=1)
    star = " <- DRS" if cand == best.k.tolist() else ""
    print(f"  {cand}: model {model_t:.3f}s | {device} {dev_t:.3f}s | "
          f"simulated {sim.mean_sojourn:.3f}s{star}")

# --- Program (6): how many executors for a 1.2s SLO? ------------------- #
need = session.plan(t_max=1.2)
print(f"\nProgram (6) @ T_max=1.2s  ->  {need.total} processors, "
      f"k = {need.k.tolist()}, model E[T] = {need.expected_sojourn:.3f}s")

sim = session.simulate(need.k, seed=2)
print(f"simulated E[T] under that allocation: {sim.mean_sojourn:.3f}s "
      f"(SLO {'met' if sim.mean_sojourn <= 1.2 else 'MISSED'})")
