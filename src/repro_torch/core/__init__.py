"""core layer of the PyTorch port: the Erlang / Jackson performance model,
the allocators (Algorithm 1, Programs (4) and (6)), the batched core, the
fleet planner, the control loop and the runtime modules (measurer,
scheduler, negotiator, rebalance); see the package docstring."""

from .erlang import (
    erlang_b,
    erlang_c,
    expected_sojourn,
    expected_sojourn_factorial,
    marginal_benefit,
    min_stable_k,
    sojourn_curve,
)
from .jackson import (
    OperatorSpec,
    Topology,
    UnstableTopologyError,
    solve_traffic_equations,
)
from .allocator import (
    AllocationResult,
    InsufficientResourcesError,
    allocate,
    assign_processors,
    assign_processors_naive,
    assign_processors_table,
    brute_force_optimal,
    greedy_increments,
    min_processors,
    min_processors_table,
)
from .batched import (
    OperatorArrays,
    expected_sojourn_batch,
    gain_table,
    operator_arrays,
    sojourn_table,
    solve_traffic_batch,
)
from .planner import FleetPlan, FleetPlanner, Tenant
from .controller import (
    ControllerParams,
    ControllerStatic,
    decide_single,
    tick_batch,
)
from .measurer import (
    EwmaSmoother,
    InstanceProbe,
    Measurer,
    MeasurementBatch,
    MeasurementSnapshot,
    WindowSmoother,
    stack_snapshots,
)
from .negotiator import LeaseChange, Machine, Negotiator, ResourcePool
from .rebalance import ExecutableCache, RebalanceCostModel, RebalancePlan
from .heterogeneous import HeterogeneousAllocation, SpeedPool, assign_heterogeneous
from .scheduler import (
    DRSScheduler,
    SchedulerConfig,
    SchedulerDecision,
    StragglerDetector,
)

__all__ = [
    "erlang_b", "erlang_c", "expected_sojourn", "expected_sojourn_factorial",
    "marginal_benefit", "min_stable_k", "sojourn_curve",
    "OperatorSpec", "Topology", "UnstableTopologyError", "solve_traffic_equations",
    "AllocationResult", "InsufficientResourcesError", "allocate",
    "assign_processors", "assign_processors_naive", "assign_processors_table",
    "brute_force_optimal", "greedy_increments",
    "min_processors", "min_processors_table",
    "OperatorArrays", "operator_arrays", "sojourn_table", "gain_table",
    "expected_sojourn_batch", "solve_traffic_batch",
    "FleetPlan", "FleetPlanner", "Tenant",
    "ControllerParams", "ControllerStatic", "decide_single", "tick_batch",
    "EwmaSmoother", "InstanceProbe", "Measurer", "MeasurementBatch",
    "MeasurementSnapshot", "WindowSmoother", "stack_snapshots",
    "LeaseChange", "Machine", "Negotiator", "ResourcePool",
    "ExecutableCache", "RebalanceCostModel", "RebalancePlan",
    "DRSScheduler", "SchedulerConfig", "SchedulerDecision", "StragglerDetector",
    "HeterogeneousAllocation", "SpeedPool", "assign_heterogeneous",
]
