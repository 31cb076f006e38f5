"""DRS-scheduled LLM serving on the port: prefill/decode chip split and a
live rebalance, on the discrete-event serving simulation.

The serving pipeline is declared once (``ServingModel.graph`` builds an
AppGraph) in which autoregressive decoding is a self-loop edge (decode ->
decode with p = 1 - 1/E[tokens]); DRS's traffic equations turn the request
rate into per-stage load and Algorithm 1 splits the chip budget.  Stage
rates come from ``--prefill-rate`` / ``--decode-rate`` (prompts / s and
tokens / s per chip, as a prefill and a decode step measure them on the
card), else the dry-run's roofline records, else illustrative defaults
(``repro_torch.launch.serve.stage_rates``).  Host code: no card needed.

    PYTHONPATH=src python examples/serve_drs_torch.py [--prefill-rate P --decode-rate D]
"""

import argparse

import numpy as np

from repro_torch.launch.serve import stage_rates
from repro_torch.serving.pipeline import ServingModel
from repro_torch.serving.router import ServingSimulation

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--arch", default="llama3.2-1b")
ap.add_argument("--prefill-rate", type=float, default=None)
ap.add_argument("--decode-rate", type=float, default=None)
args = ap.parse_args()

rates, src = stage_rates(args.arch, prefill_rate=args.prefill_rate,
                         decode_rate=args.decode_rate)
print(f"rates from {src}: prefill {rates.prefill_per_chip:.3f} req/s/chip | "
      f"decode {rates.decode_per_chip:.1f} tok/s/chip")

model = ServingModel(rates, mean_output_tokens=48.0)
# A request rate the stages can sustain: ~40% of the saturation throughput
# of a 10-chip prefill group and the matching decode load.
cap_pre = 0.4 * rates.prefill_per_chip * 10 / (1 + model.group_alpha * 9)
cap_dec = 0.4 * rates.decode_per_chip * 10 / (1 + model.group_alpha * 9) / 48.0
lam0 = min(3.0, cap_pre, cap_dec)
print(f"request rate lam0 = {lam0:.3f} req/s")
horizon = max(1200.0, 3000.0 / lam0)
sim = ServingSimulation(model, lam0, horizon=horizon, warmup=0.0, seed=7)

# Decode visits are amplified 48x by the self-loop:
graph = model.graph(lam0)
top = graph.topology()
print("per-stage traffic:", dict(zip(graph.names, np.round(top.arrival_rates, 1))))

drs = sim.drs_allocation(k_max=20)
print("DRS split @ 20 chips:", drs)

# Start from a perturbed split (decode chips pushed to prefill where
# possible), let DRS rebalance halfway through.
k_min = top.min_feasible_allocation()
spare = max(drs["decode"] - int(k_min[2]), 0)
bad = {
    "tokenize": drs["tokenize"],
    "prefill": drs["prefill"] + spare,
    "decode": drs["decode"] - spare,
    "detokenize": drs["detokenize"],
}
mid = horizon / 2
print("starting from a perturbed split:", bad)
rep = sim.run(bad, rebalance_to=drs, rebalance_at=mid)
ts = np.array([t for t, _ in rep.sojourn_series])
sj = np.array([s for _, s in rep.sojourn_series])
before = sj[(ts > mid * 0.1) & (ts < mid)].mean()
after = sj[ts > mid * 1.15].mean()
print(f"latency before rebalance: {before:.3f}s")
print(f"latency after  rebalance: {after:.3f}s "
      f"(model predicts {model.expected_latency(lam0, drs):.3f}s)")
