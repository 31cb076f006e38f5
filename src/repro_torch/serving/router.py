"""Serving runtime on the discrete-event simulator: the port of
``repro/serving/router.py``.

:class:`ServingSimulation` binds :meth:`ServingModel.graph
<repro_torch.serving.pipeline.ServingModel.graph>` to the DES backend
(``graph.bind("des")``) and runs a fixed allocation, or one that changes
mid-run, in simulated time: requests arrive, queue for the prefill and
decode chip gangs (one effective server at ``mu * k * eff(k)`` each) and
loop through decode once per output token.  :class:`ServingReport` sets
the simulated mean and p95 latency beside the model's E[T] for the same
allocation.  Host code by nature, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..core.allocator import assign_processors
from .pipeline import ServingModel

__all__ = ["ServingSimulation", "ServingReport"]


@dataclass
class ServingReport:
    mean_latency: float
    p95_latency: float
    completed: int
    allocation: dict[str, int]
    model_latency: float
    sojourn_series: list = field(default_factory=list)

    def as_dict(self) -> dict:
        return {
            "mean_latency": self.mean_latency,
            "p95_latency": self.p95_latency,
            "completed": self.completed,
            "allocation": self.allocation,
            "model_latency": self.model_latency,
        }


class ServingSimulation:
    """DES-backed serving run under a fixed or DRS-chosen allocation."""

    def __init__(self, model: ServingModel, lam0: float, *, seed: int = 0,
                 horizon: float = 600.0, warmup: float = 60.0):
        self.model = model
        self.lam0 = lam0
        self.seed = seed
        self.horizon = horizon
        self.warmup = warmup
        self.graph = model.graph(lam0)

    def session(self, *, arrival_kind: str = "exponential"):
        """The serving graph bound to the DES backend."""
        return self.graph.bind("des", seed=self.seed, horizon=self.horizon,
                               warmup=self.warmup, arrival_kind=arrival_kind)

    def run(self, allocation: dict[str, int], *, rebalance_to: dict[str, int] | None = None,
            rebalance_at: float | None = None, arrival_kind: str = "exponential"
            ) -> ServingReport:
        res = self.session(arrival_kind=arrival_kind).simulate(
            allocation, rebalance_to=rebalance_to, rebalance_at=rebalance_at, pause=1.0,
        )
        top = self.graph.topology()
        return ServingReport(
            mean_latency=res.mean_sojourn,
            p95_latency=res.p95_sojourn,
            completed=res.completed,
            allocation=dict(allocation),
            model_latency=float(top.expected_sojourn(self.graph.k_vector(allocation))),
            sojourn_series=res.sojourn_series,
        )

    def drs_allocation(self, k_max: int) -> dict[str, int]:
        alloc = assign_processors(self.graph.topology(), k_max)
        return self.graph.k_dict(alloc.k)
