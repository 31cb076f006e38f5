"""api layer of the PyTorch port: the declarative AppGraph, the sessions
that bind it to a backend, the fleet session and the scenario runner."""

from ..core.allocator import AllocationResult, InsufficientResourcesError
from ..core.jackson import Topology, UnstableTopologyError
from ..core.planner import FleetPlan, FleetPlanner, Tenant
from ..core.scheduler import SchedulerConfig, SchedulerDecision
from .graph import AppGraph, Edge, GraphValidationError, OpDef
from .session import (
    DESBackend,
    DRSSession,
    EngineBackend,
    FleetDecision,
    FleetSession,
    ScenarioReport,
    ScenarioRunner,
)

__all__ = [
    "AppGraph",
    "Edge",
    "OpDef",
    "GraphValidationError",
    "DRSSession",
    "EngineBackend",
    "DESBackend",
    "FleetSession",
    "FleetDecision",
    "ScenarioRunner",
    "ScenarioReport",
    "FleetPlan",
    "FleetPlanner",
    "Tenant",
    "SchedulerConfig",
    "SchedulerDecision",
    "AllocationResult",
    "InsufficientResourcesError",
    "Topology",
    "UnstableTopologyError",
]
