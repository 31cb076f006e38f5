"""Carry a fleet across from the JAX package.

:func:`from_reference` reads the numpy attributes of a
``repro.streaming.batchsim.BatchArrays``, ``repro.core.controller
.ControllerStatic`` and ``ControllerParams`` by duck typing -- this module
imports nothing of ``repro`` -- and builds this package's objects plus the
tick-0 :class:`~repro_torch.core.controller.ControllerState` on the chosen
device; :func:`static_from_reference` and :func:`params_from_reference`
carry the two controller bundles alone, and
:func:`measurement_from_reference` a ``repro.core.measurer
.MeasurementBatch``, so ``tick_batch`` gets the same inputs in both
packages.  :func:`scenario_from_reference` rebuilds a reference ``Scenario``
(graph, traces, settings) as this package's :class:`Scenario`.  With them
both packages run exactly the same fleet.  :func:`vld_from_reference`
carries a reference ``VLDConfig`` and logo library (the VLD path's
"weights") across, :func:`model_params_from_reference` a reference model's
parameter pytree.  :func:`mpc_config_from_reference`,
:func:`predictor_params_from_reference` and
:func:`compaction_config_from_reference` carry the proactive and sparse
decide knobs, :func:`forecast_state_from_reference` a forecast state (as
numpy arrays or, with ``device=``, tensors).  For the fleet and the soak:
:func:`graph_from_reference` (an ``AppGraph``, without its compute
``fn``s), :func:`topology_from_reference`, :func:`tenant_from_reference`,
:func:`snapshot_from_reference` (a ``MeasurementSnapshot``),
:func:`speed_pool_from_reference`, :func:`fpd_config_from_reference` and
:func:`controller_state_from_reference` (a JAX ``ControllerState``, its
``tick`` as a host int).  For training, :func:`train_state_from_reference`
and :func:`opt_state_from_reference` carry a JAX ``TrainState`` /
``OptState`` across (parameters in the config's dtype, moments in their
own), and :func:`train_state_to_arrays` gives a port ``TrainState`` back as
numpy arrays in the same tree (bf16 leaves widened to float32, exactly), for
the JAX package to load.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .api.graph import AppGraph, Edge, OpDef
from .core.controller import ControllerParams, ControllerState, ControllerStatic, init_state
from .core.controller import CompactionConfig
from .core.heterogeneous import SpeedPool
from .core.jackson import OperatorSpec, Topology
from .core.measurer import MeasurementBatch, MeasurementSnapshot
from .core.planner import Tenant
from .forecast.mpc import MPCConfig
from .forecast.predictors import PredictorParams
from .device import resolve_device
from .streaming.apps.fpd import FPDConfig
from .streaming.apps.vld import VLDConfig
from .streaming.batchsim import BatchArrays
from .streaming.scenarios import ArrivalTrace, Scenario

__all__ = ["from_reference", "static_from_reference", "params_from_reference",
           "measurement_from_reference", "scenario_from_reference", "vld_from_reference",
           "model_params_from_reference", "predictor_params_from_reference",
           "mpc_config_from_reference", "compaction_config_from_reference",
           "forecast_state_from_reference", "graph_from_reference",
           "topology_from_reference", "tenant_from_reference", "snapshot_from_reference",
           "speed_pool_from_reference", "fpd_config_from_reference",
           "controller_state_from_reference", "opt_state_from_reference",
           "train_state_from_reference", "train_state_to_arrays"]


def _arr(x, dtype=None):
    return None if x is None else np.array(x, dtype=dtype)


def from_reference(arrays, static, params, k0, *, device=None, dtype=None
                   ) -> tuple[BatchArrays, ControllerStatic, ControllerParams, ControllerState]:
    """``(arrays, static, params, state)`` for this package from the JAX
    package's ``BatchArrays`` / ``ControllerStatic`` / ``ControllerParams``
    and a ``[B, N]`` starting allocation ``k0``.  ``state`` is the tick-0
    loop state on ``device`` (default: the CUDA device) in ``dtype``
    (default float32)."""
    dev = resolve_device(device)
    dtype = torch.float32 if dtype is None else dtype
    arr = BatchArrays(
        ext=_arr(arrays.ext, np.float64),
        routing=_arr(arrays.routing, np.float64),
        mu=_arr(arrays.mu, np.float64),
        group=_arr(arrays.group, bool),
        alpha=_arr(arrays.alpha, np.float64),
        cap_queue=_arr(arrays.cap_queue, np.float64),
        dt=float(arrays.dt),
        warmup_steps=int(arrays.warmup_steps),
        active=_arr(arrays.active, bool),
        speed=_arr(getattr(arrays, "speed", None), np.float64),
        ca2=_arr(getattr(arrays, "ca2", None), np.float64),
        cs2=_arr(getattr(arrays, "cs2", None), np.float64),
    )
    return (arr, static_from_reference(static), params_from_reference(params),
            init_state(np.asarray(k0), device=dev, dtype=dtype))


def static_from_reference(static) -> ControllerStatic:
    """This package's :class:`ControllerStatic` from the reference's."""
    return ControllerStatic(
        base_routing=_arr(static.base_routing, np.float64),
        group=_arr(static.group, bool),
        alpha=_arr(static.alpha, np.float64),
        active=_arr(static.active, bool),
        speed=_arr(static.speed, np.float64),
        n_ops=_arr(static.n_ops, np.int64),
        names=tuple(tuple(nm) for nm in static.names),
    )


def params_from_reference(params) -> ControllerParams:
    """This package's :class:`ControllerParams` from the reference's."""
    return ControllerParams(
        t_max=_arr(params.t_max, np.float64),
        k_max=_arr(params.k_max, np.int64),
        headroom=_arr(params.headroom, np.float64),
        scale_in_hysteresis=_arr(params.scale_in_hysteresis, np.float64),
        min_improvement=_arr(params.min_improvement, np.float64),
        horizon_seconds=_arr(params.horizon_seconds, np.float64),
        allocator=tuple(params.allocator),
        fused_decide=bool(getattr(params, "fused_decide", False)),
    )


def measurement_from_reference(meas) -> MeasurementBatch:
    """This package's :class:`MeasurementBatch` from the reference's."""
    return MeasurementBatch(
        lam_hat=_arr(meas.lam_hat, np.float64),
        mu_hat=_arr(meas.mu_hat, np.float64),
        lam0_hat=_arr(meas.lam0_hat, np.float64),
        sojourn_hat=_arr(meas.sojourn_hat, np.float64),
        t=float(meas.t),
        drop_hat=_arr(meas.drop_hat, np.float64),
    )


def graph_from_reference(g) -> AppGraph:
    """This package's :class:`AppGraph` with the reference graph's operators,
    edges and sources (the operators' compute ``fn``s stay behind: the
    result is a model, for the planner and the simulators)."""
    ops = [
        OpDef(name=op.name, mu=op.mu, scaling=op.scaling, group_alpha=op.group_alpha,
              min_k=op.min_k, max_k=op.max_k, service_kind=op.service_kind,
              service_cv=op.service_cv)
        for op in g.ops
    ]
    edges = [Edge(e.src, e.dst, e.multiplicity) for e in g.edges]
    lam0 = np.asarray(g.lam0_vector())
    sources = {name: float(lam0[i]) for i, name in enumerate(g.names) if lam0[i] > 0}
    return AppGraph(ops, edges, sources, arrival_kind=g.arrival_kind,
                    validate_stability=g.validate_stability)


def scenario_from_reference(s) -> Scenario:
    """This package's :class:`Scenario` with the reference scenario's graph,
    traces and settings (read by attribute name)."""
    graph = graph_from_reference(s.graph)
    trace_fields = [f.name for f in dataclasses.fields(ArrivalTrace)]
    traces = {
        name: ArrivalTrace(**{f: getattr(tr, f) for f in trace_fields})
        for name, tr in s.traces.items()
    }
    policy = s.overload_policy
    kw = {
        f.name: getattr(s, f.name)
        for f in dataclasses.fields(Scenario)
        if f.name not in ("graph", "traces", "overload_policy")
    }
    return Scenario(graph=graph, traces=traces,
                    overload_policy=getattr(policy, "kind", policy), **kw)


def vld_from_reference(cfg, library) -> tuple[VLDConfig, np.ndarray]:
    """This package's :class:`VLDConfig` with the reference config's fields
    (read by name) and the logo library as a float32 numpy array."""
    port_cfg = VLDConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(VLDConfig)})
    return port_cfg, np.array(library, dtype=np.float32)


def _tensor(x, dtype, device) -> torch.Tensor:
    """One array-like (numpy, or anything with ``__array__``) as a tensor;
    a bfloat16 array (``ml_dtypes``) passes bit for bit through int16."""
    a = np.array(x)  # a writable, contiguous host copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def model_params_from_reference(params, cfg, *, device=None) -> dict:
    """The reference model's parameter pytree (nested dicts of arrays: JAX
    arrays or their numpy copies) as this package's dict, same names and
    stacked ``[L, ...]`` layout, in ``cfg.dtype`` on ``device`` (default:
    the CUDA device)."""
    dev = resolve_device(device)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return _tensor(tree, cfg.dtype, dev)

    return walk(params)


def predictor_params_from_reference(params) -> PredictorParams:
    """This package's :class:`PredictorParams` from the reference's."""
    return PredictorParams(**{f.name: getattr(params, f.name)
                              for f in dataclasses.fields(PredictorParams)})


def mpc_config_from_reference(cfg) -> MPCConfig:
    """This package's :class:`MPCConfig` from the reference's (its
    predictor carried too)."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(MPCConfig)}
    kw["predictor"] = predictor_params_from_reference(cfg.predictor)
    return MPCConfig(**kw)


def compaction_config_from_reference(cfg) -> CompactionConfig:
    """This package's :class:`CompactionConfig` from the reference's."""
    cap = cfg.b_active_cap
    return CompactionConfig(b_active_cap=None if cap is None else tuple(int(w) for w in cap))


def forecast_state_from_reference(state, *, device=None, dtype=None) -> tuple:
    """A reference forecast state (the flat tuple of ``forecast_init_state``
    / ``forecast_step``: numpy or JAX arrays) as float64 numpy arrays, or as
    tensors on ``device`` in ``dtype`` (default float32) when a device is
    given."""
    arrays = tuple(np.array(x, dtype=np.float64) for x in state)
    if device is None:
        return arrays
    dev = resolve_device(device)
    dtype = torch.float32 if dtype is None else dtype
    return tuple(torch.as_tensor(a, dtype=dtype, device=dev) for a in arrays)


def topology_from_reference(top) -> Topology:
    """This package's :class:`Topology` from the reference's (operator specs,
    external arrivals and routing, read by name)."""
    fields = [f.name for f in dataclasses.fields(OperatorSpec)]
    ops = [OperatorSpec(**{f: getattr(op, f) for f in fields}) for op in top.operators]
    return Topology(ops, _arr(top.lam0, np.float64), _arr(top.routing, np.float64))


def tenant_from_reference(t) -> Tenant:
    """This package's planner :class:`Tenant` from the reference's (its graph
    or its topology carried across)."""
    return Tenant(
        name=t.name,
        graph=None if t.graph is None else graph_from_reference(t.graph),
        topology=None if t.topology is None else topology_from_reference(t.topology),
        t_max=t.t_max, weight=t.weight,
    )


def snapshot_from_reference(snap) -> MeasurementSnapshot:
    """This package's :class:`MeasurementSnapshot` from the reference's."""
    return MeasurementSnapshot(
        lam_hat=_arr(snap.lam_hat, np.float64), mu_hat=_arr(snap.mu_hat, np.float64),
        lam0_hat=float(snap.lam0_hat), sojourn_hat=float(snap.sojourn_hat), t=float(snap.t),
        drop_hat=_arr(snap.drop_hat, np.float64),
    )


def speed_pool_from_reference(pool) -> SpeedPool:
    """This package's :class:`SpeedPool` from the reference's."""
    return SpeedPool(tuple((float(s), int(n)) for s, n in pool.counts))


def fpd_config_from_reference(cfg) -> FPDConfig:
    """This package's :class:`FPDConfig` with the reference config's fields."""
    return FPDConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(FPDConfig)})


def controller_state_from_reference(state, *, device=None, dtype=None) -> ControllerState:
    """A JAX ``ControllerState`` (arrays, or their numpy copies) as this
    package's on ``device`` (default: the CUDA device): the float leaves in
    ``dtype`` (default float32), ``k`` int32, ``tick`` a host int."""
    dev = resolve_device(device)
    dtype = torch.float32 if dtype is None else dtype

    def f(x):
        return torch.as_tensor(np.array(x), device=dev).to(dtype)

    return ControllerState(
        q=f(state.q), served_prev=f(state.served_prev),
        k=torch.as_tensor(np.array(state.k), device=dev).to(torch.int32),
        acc=tuple(f(a) for a in state.acc), tick=int(np.asarray(state.tick)),
        fstate=tuple(f(x) for x in state.fstate),
    )


def _tree_tensors(tree, *, device, dtype=None):
    """Every leaf of a nested dict as a tensor on ``device`` (in ``dtype``,
    else its own dtype; bf16 bit for bit)."""
    if isinstance(tree, dict):
        return {k: _tree_tensors(v, device=device, dtype=dtype) for k, v in tree.items()}
    t = _tensor(tree, None, device)
    return t if dtype is None else t.to(dtype)


def opt_state_from_reference(opt, *, device=None):
    """A JAX ``OptState`` (step, mu, nu) as the port's, moments in their own
    dtype on ``device`` (default: the CUDA device)."""
    from .training.optimizer import OptState

    dev = resolve_device(device)
    return OptState(step=torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32, device=dev),
                    mu=_tree_tensors(opt.mu, device=dev), nu=_tree_tensors(opt.nu, device=dev))


def train_state_from_reference(state, cfg, *, device=None):
    """A JAX ``TrainState`` (params, opt, step) as the port's: parameters in
    ``cfg.dtype`` on ``device`` (default: the CUDA device)."""
    from .training.train_step import TrainState

    dev = resolve_device(device)
    return TrainState(params=model_params_from_reference(state.params, cfg, device=dev),
                      opt=opt_state_from_reference(state.opt, device=dev),
                      step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                                        device=dev))


def train_state_to_arrays(state):
    """A port ``TrainState`` as the same NamedTuples of host numpy arrays
    (bf16 leaves as float32, which holds them exactly; steps as int32
    scalars), for ``jnp.asarray`` on the JAX side."""
    from .training.optimizer import OptState
    from .training.train_step import TrainState

    def arr(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()

    def walk(tree):
        return {k: walk(v) for k, v in tree.items()} if isinstance(tree, dict) else arr(tree)

    return TrainState(params=walk(state.params),
                      opt=OptState(step=arr(state.opt.step), mu=walk(state.opt.mu),
                                   nu=walk(state.opt.nu)),
                      step=arr(state.step))
