"""streaming layer of the PyTorch port: the discrete-event simulator, the
live engine, the batched queue simulator and the scenario suite (see the
package docstring)."""

from .batchsim import BatchArrays, BatchQueueSim, BatchSimResult
from .des import (
    ArrivalProcess,
    NetworkSimulator,
    ServiceProcess,
    SimConfig,
    SimResult,
    simulate_allocation,
)
from .engine import Operator, StreamEngine, StreamTuple
from .overload import OVERLOAD_POLICIES, OverloadPolicy
from .scenarios import (
    ArrivalTrace,
    Scenario,
    fpd_scenario,
    pack_scenarios,
    random_appgraph,
    scenario_matrix,
    vld_scenario,
)

__all__ = [
    "ArrivalProcess",
    "NetworkSimulator",
    "ServiceProcess",
    "SimConfig",
    "SimResult",
    "simulate_allocation",
    "Operator",
    "StreamEngine",
    "StreamTuple",
    "OverloadPolicy",
    "OVERLOAD_POLICIES",
    "ArrivalTrace",
    "Scenario",
    "BatchArrays",
    "BatchQueueSim",
    "BatchSimResult",
    "pack_scenarios",
    "random_appgraph",
    "scenario_matrix",
    "vld_scenario",
    "fpd_scenario",
]
