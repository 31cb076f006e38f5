"""Serving driver: DRS-scheduled prefill/decode split (simulated time).

Takes stage service rates from the card (``--prefill-rate`` prompts / s
and ``--decode-rate`` tokens / s per chip, as measured by a prefill and a
decode step), else from the port's dry-run records (``build/dryrun``,
written by ``python -m repro_torch.launch.dryrun`` on the H100's roofline)
when present, else the reference's defaults; plans the chip split (Program (4), or (6) with
``--t-max``) and runs the discrete-event serving simulation under it,
printing latency beside the queueing model's prediction.  Host code: no
card is needed.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --rate 4.0 --chips 24 --mean-tokens 64
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..configs import ARCHS
from ..serving.pipeline import ServingModel, StageRates, rates_from_dryrun
from ..serving.router import ServingSimulation

__all__ = ["RESULTS", "DEFAULT_RATES", "stage_rates", "plan", "simulate", "main"]

#: The port's dry-run records (``python -m repro_torch.launch.dryrun``).
RESULTS = Path(__file__).resolve().parents[3] / "build" / "dryrun"
#: The reference launcher's rates when it finds no dry-run record.
DEFAULT_RATES = StageRates(prefill_per_chip=0.5, decode_per_chip=40.0)


def stage_rates(arch: str, *, prefill_rate: float | None = None,
                decode_rate: float | None = None,
                results_dir=None) -> tuple[StageRates, str]:
    """(rates, where they came from): the card's measured rates when given
    (both or neither), else the dry-run records in ``results_dir`` (default
    :data:`RESULTS`), else :data:`DEFAULT_RATES`."""
    if (prefill_rate is None) != (decode_rate is None):
        raise ValueError("give both --prefill-rate and --decode-rate, or neither")
    if prefill_rate is not None:
        return StageRates(prefill_per_chip=prefill_rate, decode_per_chip=decode_rate), \
            "measured on the card"
    try:
        return rates_from_dryrun(arch, RESULTS if results_dir is None else results_dir), \
            "dry-run roofline"
    except (FileNotFoundError, KeyError):
        return DEFAULT_RATES, "defaults (no dry-run records found)"


def plan(rates: StageRates, rate: float, *, chips: int | None = 24,
         t_max: float | None = None, mean_tokens: float = 64.0):
    """(model, allocation, split): DRS's chip split of the pipeline at
    ``rate`` requests / s."""
    model = ServingModel(rates, mean_output_tokens=mean_tokens)
    alloc = model.plan(rate, k_max=chips, t_max=t_max)
    return model, alloc, model.split(alloc)


def simulate(model: ServingModel, split: dict, rate: float, *, horizon: float = 900.0):
    """The split through the discrete-event serving simulation (warm-up a
    tenth of the horizon); returns its ``ServingReport``."""
    return ServingSimulation(model, rate, horizon=horizon, warmup=horizon / 10).run(split)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCHS, default="llama3.2-1b")
    ap.add_argument("--rate", type=float, default=4.0, help="requests/sec")
    ap.add_argument("--chips", type=int, default=24)
    ap.add_argument("--t-max", type=float, default=None,
                    help="latency SLO (s): Program (6) sizing instead of fixed chips")
    ap.add_argument("--mean-tokens", type=float, default=64.0)
    ap.add_argument("--horizon", type=float, default=900.0)
    ap.add_argument("--prefill-rate", type=float, default=None,
                    help="prompts/s per chip measured on the card")
    ap.add_argument("--decode-rate", type=float, default=None,
                    help="tokens/s per chip measured on the card")
    args = ap.parse_args(argv)

    rates, src = stage_rates(args.arch, prefill_rate=args.prefill_rate,
                             decode_rate=args.decode_rate)
    print(f"stage rates from {src}: prefill {rates.prefill_per_chip:.3f} req/s/chip, "
          f"decode {rates.decode_per_chip:.1f} tok/s/chip")
    model, alloc, split = plan(rates, args.rate, chips=args.chips, t_max=args.t_max,
                               mean_tokens=args.mean_tokens)
    print(f"DRS allocation (Program {'6' if args.t_max else '4'}): {split} "
          f"-> model E[T] = {alloc.expected_sojourn:.3f}s")
    rep = simulate(model, split, args.rate, horizon=args.horizon)
    print(json.dumps(rep.as_dict(), indent=2))
    return {"arch": args.arch, "rates": rates, "source": src, "model": model,
            "alloc": alloc, "split": split, "report": rep}


if __name__ == "__main__":
    main()
