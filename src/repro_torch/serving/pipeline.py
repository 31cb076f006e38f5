"""LLM serving as a DRS-scheduled operator network (the port of
``repro/serving/pipeline.py``).

The pipeline has two device-side operators -- **prefill** and **decode**
-- plus host-side tokenize / detokenize.  Autoregressive decoding is a
Jackson self-loop: a request that just produced a token returns to the
decode queue with probability p = 1 - 1 / E[output_len], so the traffic
equations give lambda_decode = lambda_0 * E[output_len].  DRS Program
(4) / (6) then splits chips between the prefill and decode groups.

Service rates are per-chip priors: measured on the card (prompts / s of a
prefill, tokens / s of a decode step; ``launch/serve.py --prefill-rate /
--decode-rate``), or read by :func:`rates_from_dryrun` from the dry-run's
roofline records, whose port waits (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

from ..api.graph import AppGraph, Edge, OpDef
from ..core.allocator import AllocationResult, allocate
from ..core.jackson import Topology

__all__ = ["StageRates", "ServingModel", "rates_from_dryrun"]


@dataclass(frozen=True)
class StageRates:
    """Per-chip service rates (requests / s / chip) for the two stages."""

    prefill_per_chip: float  # prompts / s per chip
    decode_per_chip: float  # tokens / s per chip (one decode visit = 1 token)


def rates_from_dryrun(arch: str, results_dir: str | Path,
                      mesh: str = "pod16x16") -> StageRates:
    """Stage rates from the dry-run's roofline records
    ``{arch}--{shape}--{mesh}.json`` (the reference's format): the bound of
    a compiled step is max(compute, memory, collective) seconds; a
    ``prefill_32k`` step serves 32 requests and a ``decode_32k`` step 128
    tokens on the record's ``chips``.  Raises ``FileNotFoundError`` for a
    missing record or one whose status is not ``"ok"``."""
    results_dir = Path(results_dir)

    def load(shape):
        rec = json.loads((results_dir / f"{arch}--{shape}--{mesh}.json").read_text())
        if rec.get("status") != "ok":
            raise FileNotFoundError(f"no ok dry-run for {arch} x {shape}")
        r = rec["roofline"]
        return max(r["compute_s"], r["memory_s"], r["collective_s"]), rec

    pre_bound, pre = load("prefill_32k")
    dec_bound, _dec = load("decode_32k")
    pre_batch, dec_batch = 32, 128  # requests / tokens per compiled step
    chips = pre["chips"]
    return StageRates(prefill_per_chip=pre_batch / (pre_bound * chips),
                      decode_per_chip=dec_batch / (dec_bound * chips))


class ServingModel:
    """Jackson model of the serving pipeline + DRS allocation calls."""

    def __init__(
        self,
        rates: StageRates,
        *,
        mean_output_tokens: float = 64.0,
        group_alpha: float = 0.01,
        host_tokenize_rate: float = 2000.0,
    ):
        if mean_output_tokens < 1:
            raise ValueError("mean_output_tokens must be >= 1")
        self.rates = rates
        self.mean_out = mean_output_tokens
        self.group_alpha = group_alpha
        self.host_rate = host_tokenize_rate
        self._names: list[str] | None = None

    def graph(self, lam0: float) -> AppGraph:
        """tokenize (host) -> prefill -> decode (leaking self-loop at
        p = 1 - 1 / E[output_len]) -> detokenize (host); the chip stages use
        "group" scaling."""
        p_loop = 1.0 - 1.0 / self.mean_out
        edges = [
            Edge("tokenize", "prefill"),
            Edge("prefill", "decode"),  # first token
            Edge("decode", "detokenize", multiplicity=1.0 - p_loop),
        ]
        if p_loop > 0:  # mean_output_tokens == 1: single visit, no loop
            edges.append(Edge("decode", "decode", multiplicity=p_loop))
        return AppGraph(
            [
                OpDef("tokenize", mu=self.host_rate),
                OpDef("prefill", mu=self.rates.prefill_per_chip, scaling="group",
                      group_alpha=self.group_alpha),
                OpDef("decode", mu=self.rates.decode_per_chip, scaling="group",
                      group_alpha=self.group_alpha),
                OpDef("detokenize", mu=self.host_rate),
            ],
            edges,
            {"tokenize": lam0},
        )

    @property
    def names(self) -> list[str]:
        if self._names is None:
            self._names = self.graph(0.0).names
        return self._names

    def topology(self, lam0: float) -> Topology:
        """Compiled Jackson model of :meth:`graph`."""
        return self.graph(lam0).topology()

    def plan(self, lam0: float, *, k_max: int | None = None,
             t_max: float | None = None) -> AllocationResult:
        """DRS allocation for the pipeline (Program 4 and / or 6)."""
        return allocate(self.topology(lam0), k_max=k_max, t_max=t_max)

    def split(self, alloc: AllocationResult) -> dict[str, int]:
        return dict(zip(self.names, alloc.k.tolist()))

    def expected_latency(self, lam0: float, k: dict[str, int]) -> float:
        graph = self.graph(lam0)
        return graph.topology().expected_sojourn(graph.k_vector(k))
