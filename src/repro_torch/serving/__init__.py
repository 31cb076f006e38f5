"""LLM serving under DRS: the prefill -> decode Jackson pipeline (see
``pipeline.py``) and its discrete-event serving simulation (``router.py``)."""

from .pipeline import ServingModel, StageRates, rates_from_dryrun
from .router import ServingReport, ServingSimulation

__all__ = [
    "ServingModel", "StageRates", "rates_from_dryrun",
    "ServingReport", "ServingSimulation",
]
