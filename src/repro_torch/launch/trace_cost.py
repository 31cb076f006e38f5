"""Per-device cost of one step of the port, from a trace on meta tensors
(the counterpart of ``repro/launch/hlo_cost.py``).

The reference costs the optimized HLO XLA compiled for the mesh.  The port
has no HLO: :class:`CostTrace`, a ``TorchDispatchMode``, runs around the
port's own ``prefill``, ``decode_step`` or train step on ``device="meta"``
tensors at the cell's global shapes (nothing is allocated) and costs each
PyTorch operation as it runs.  The parameters, cache and batch are
registered first with their specs (``distributed/sharding.py``); every
tensor then carries the set of mesh axes its data is split over, and a
tensor read from a parameter or cache leaf (a layer's slice, a transpose)
keeps the leaf's spec dim by dim.

What it records, per device:

* **dot FLOPs**: matmul-class operations (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``), counted by ``torch.utils.flop_counter``'s registry, plus
  the products of the kernels (``kernels/cost.py``), whose meta faces
  charge the trace;
* **HBM traffic**, the reference's fusion model at operation level:
  matmul-class operations, reductions, sorts and kernel calls read their
  operands and write their result; gathers (``index``, ``index_select``,
  ``gather``, ``embedding``) cost twice their output; ``index_put_``,
  scatters, ``index_copy_`` and copies into part of a tensor cost twice
  the update; elementwise and layout operations (views, casts, whole
  copies) cost nothing: a fused kernel would not touch memory for them;
* **peak live bytes**: the most storage bytes alive at once, each storage
  counted once however many views share it (its bytes over the ways its
  first tensor is split), the registered arguments included;
* **collective bytes and counts by kind**, under the reference's kind
  names, each the bytes of the collective's result on one device:

  - a product that contracts a parameter's dim sharded on a non-batch
    axis (tensor parallelism: ``wo`` over heads, a SwiGLU's down
    projection over ``d_ff``) is an all-reduce of its per-device output
    over that axis, in the forward and again in the backward;
  - a product whose activation is split along its contracted dim over a
    non-batch axis that the parameter's rows do not carry gathers the
    activation whole over that axis first (an all-gather of it) when the
    parameter's columns are split over the same axis, and otherwise
    slices the rows to match, which makes it a contraction over that axis
    (the all-reduce above): rwkv6's shifted mixes, whose token-shift
    carries the step lays out split along ``d_model``
    (``launch/dryrun.py:STEP_LAYOUT``), as XLA's partitioner does in the
    reference's records (the r / k / v / g and channel-mix projections
    gathered, the decay LoRA's first factor reduced);
  - FSDP (a parameter's non-expert dim on a batch axis: ``d_model`` on
    "data" in training, mixtral's experts at serve time) is an all-gather
    of the parameter before its forward use and again before its backward
    use, and a reduce-scatter of its gradient, one of each per layer.  The
    batch axes are those the step's batch takes (``launch/dryrun.py``
    passes the tokens' spec): at batch 1 (``long_500k``) it takes none, so
    mixtral's d_model on "data" is split as a tensor-parallel dim and its
    products contract over "data" (an all-reduce of the output), as XLA
    lays the reference's batch-1 step out, and nothing is gathered;
  - a data-parallel parameter (on no batch axis) gets an all-reduce of
    its gradient over the batch axes;
  - experts on a batch axis cost two all-to-alls of the per-device
    dispatch buffer [E / n, C, D] per MoE layer, and two more in the
    backward;
  - a decode cache whose sequence is sharded (``kv_seq`` on "model")
    costs the partial-softmax combine per attention layer: an all-reduce
    of the output [B, H, Dh] and two [B, H] float32 statistics.

Per-device work divides each operation by the ways its operands are
split: a batch factor (the batch axes of the input, from ``batch_spec``),
and the non-batch axes of the parameter or cache leaf it reads (found by
tensor identity), ``kv_seq``'s for decode attention.  A dim the
divisibility guard left replicated counts whole on each device (8 KV heads
under a 16-wide model axis, whisper's vocabulary of 51,865, batch 1 at
``long_500k``).  It is a model, as the reference's is: it ranks
bottlenecks and sizes a cell, and XLA's partitioner may lay a step out
otherwise (the reference gathers llama's vocab-sharded logits whole for
its loss).
"""

from __future__ import annotations

import math
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from ..distributed.sharding import spec_axes
from ..kernels import cost as kcost

__all__ = ["TraceCost", "CostTrace"]

aten = torch.ops.aten

_MM = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm}
_FULL_READ = {
    aten.sum, aten.mean, aten.amax, aten.amin, aten.max, aten.min, aten.prod, aten.argmax,
    aten.argmin, aten.var, aten.var_mean, aten.std, aten.std_mean, aten.logsumexp,
    aten._softmax, aten._log_softmax, aten._softmax_backward_data,
    aten._log_softmax_backward_data, aten.sort, aten.topk, aten.cumsum, aten.cumprod,
    aten.searchsorted, aten.linalg_vector_norm, aten.norm, aten.all, aten.any,
}
_WINDOW_READ = {aten.index, aten.index_select, aten.gather, aten.embedding}
# operation -> the index of its update operand
_WINDOW_WRITE = {
    aten.index_put_: 2, aten.index_put: 2, aten._index_put_impl_: 2, aten.scatter: 3,
    aten.scatter_: 3, aten.scatter_add: 3, aten.scatter_add_: 3, aten.scatter_reduce: 3,
    aten.scatter_reduce_: 3, aten.index_copy_: 3, aten.index_copy: 3, aten.index_add_: 3,
    aten.index_add: 3, aten.slice_scatter: 1, aten.select_scatter: 1,
}
_SAME_SPEC = {aten.slice, aten.narrow, aten.detach, aten.alias, aten.split,
              aten.split_with_sizes, aten.chunk}


@dataclass
class TraceCost:
    """One step's per-device cost (the reference's ``HloCost`` fields)."""

    flops: float = 0.0
    traffic_bytes: float = 0.0
    bytes_by_kind: dict = field(default_factory=dict)
    count_by_kind: dict = field(default_factory=dict)
    traffic_by_kind: dict = field(default_factory=dict)
    dot_count: int = 0
    kernel_calls: dict = field(default_factory=dict)
    peak_bytes: float = 0.0

    @property
    def collective_bytes(self) -> float:
        return float(sum(self.bytes_by_kind.values()))

    def add_traffic(self, kind: str, b: float) -> None:
        self.traffic_bytes += b
        self.traffic_by_kind[kind] = self.traffic_by_kind.get(kind, 0.0) + b

    def add_collective(self, kind: str, b: float, count: int = 1) -> None:
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0.0) + b
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + count


@dataclass
class _Info:
    axes: frozenset = frozenset()
    spec: tuple | None = None  # per dim, for views of a registered leaf
    leaf: str | None = None
    kind: str | None = None  # "param", "cache", "input", "state"


_NONE = _Info()


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(obj, out: list) -> list:
    """The tensors of an operation's (nested list / tuple / dict) arguments
    or results, in order."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _tensors(x, out)
    elif isinstance(obj, dict):
        for x in obj.values():
            _tensors(x, out)
    return out


def _split(n: int, ways: int) -> int:
    """``n`` over ``ways`` devices, or whole when they do not divide it."""
    return n // ways if ways > 1 and n % ways == 0 else n


class CostTrace(TorchDispatchMode):
    """Cost every operation run inside it on meta tensors for ``mesh``
    under ``rules``; :meth:`register` the step's arguments first.  The
    result accumulates in :attr:`cost`."""

    def __init__(self, mesh, rules: dict):
        super().__init__()
        self.mesh = mesh
        self._one = frozenset(a for a, n in mesh.shape.items() if n == 1)
        self.batch_axes = self.axes_of(rules.get("batch"))
        self.cost = TraceCost()
        self._info = WeakIdKeyDictionary()
        self._live: dict[int, float] = {}
        self._current = 0.0
        self._quiet = False
        self.params: dict[str, tuple[torch.Tensor, tuple, tuple]] = {}

    # ------------------------------------------------------------ setup -- #
    def register(self, tensor: torch.Tensor, spec: tuple, kind: str, name: str,
                 logical: tuple | None = None) -> None:
        """An argument of the step: a ``kind`` leaf ("param", "cache",
        "input" or "state") named ``name`` laid out by ``spec``; a
        parameter also gives its ``logical`` axes."""
        spec = tuple(spec) + (None,) * (tensor.ndim - len(spec))
        axes = frozenset().union(*(self.axes_of(e) for e in spec))
        self._info[tensor] = _Info(axes, spec, name, kind)
        if kind == "param":
            self.params[name] = (tensor, spec, tuple(logical or (None,) * tensor.ndim))
        self._track(tensor)

    def axes_of(self, entry) -> frozenset:
        """The mesh axes of a spec entry, less those of size 1 (a
        collective over one device is none)."""
        return frozenset(spec_axes(entry)) - self._one

    def ways(self, axes) -> int:
        return math.prod(self.mesh.shape[a] for a in axes)

    def info(self, t) -> _Info:
        return self._info.get(t, _NONE) if isinstance(t, torch.Tensor) else _NONE

    def _per_device(self, t) -> float:
        return _nbytes(t) / self.ways(self.info(t).axes)

    # ----------------------------------------------------------- memory -- #
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        b = st.nbytes() / self.ways(self.info(t).axes)
        self._live[key] = b
        self._current += b
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._current)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self._current -= self._live.pop(key, 0.0)

    # --------------------------------------------------------- dispatch -- #
    def __enter__(self):
        self._prev_tracer = kcost.set_tracer(self)
        return super().__enter__()

    def __exit__(self, *exc):
        kcost.set_tracer(self._prev_tracer)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        packet = func._overloadpacket
        flat_in = _tensors(kwargs, _tensors(args, []))
        flat_out = _tensors(out, [])
        if packet in _MM:
            out_axes = self._matmul(packet, args, kwargs, out)
        else:
            out_axes = self._gather_axes(packet, args)
            if out_axes is None:
                out_axes = frozenset().union(*(self.info(t).axes for t in flat_in))
            self._traffic(packet, args, flat_in, flat_out, out_axes)
        spec, leaf, kind = self._view_spec(packet, args, out)
        for t in flat_out:
            if t in self._info and any(t is a for a in flat_in):
                continue  # in place: the tensor keeps its layout
            t_spec = spec if spec is not None and len(spec) == t.ndim else None
            axes = (frozenset().union(*(self.axes_of(e) for e in t_spec)) if t_spec is not None
                    else out_axes)
            self._info[t] = _Info(axes, t_spec, leaf, kind)
            self._track(t)
        return out

    def _view_spec(self, packet, args, out):
        """The per-dim spec of a view of a registered leaf, or None."""
        src = self.info(args[0]) if args else _NONE
        if src.spec is None:
            return None, None, None
        spec = src.spec
        if packet in _SAME_SPEC:
            pass
        elif packet is aten.select:
            dim = args[1] % len(spec)
            spec = spec[:dim] + spec[dim + 1:]
        elif packet in (aten.t, aten.numpy_T):
            spec = spec[::-1]
        elif packet is aten.transpose:
            d0, d1 = (d % len(spec) for d in args[1:3])
            s = list(spec)
            s[d0], s[d1] = s[d1], s[d0]
            spec = tuple(s)
        elif packet is aten.permute:
            spec = tuple(spec[d % len(spec)] for d in args[1])
        elif packet is aten.unsqueeze:
            dim = args[1] % (len(spec) + 1)
            spec = spec[:dim] + (None,) + spec[dim:]
        elif packet is aten.expand:
            spec = (None,) * (len(args[1]) - len(spec)) + spec
        elif packet in (aten.view, aten._unsafe_view, aten.reshape):
            if tuple(out.shape) != tuple(args[0].shape):
                return None, None, None
        else:
            return None, None, None
        return spec, src.leaf, src.kind

    def _gather_axes(self, packet, args):
        """The axes of rows gathered from a parameter (an embedding): the
        indices' axes and the parameter's other dims' non-batch axes (a
        batch axis there is FSDP: the rows arrive whole)."""
        src = self.info(args[0]) if args else _NONE
        if src.kind != "param" or src.spec is None:
            return None
        if packet is aten.index:
            index, dims = args[1], [i for i, t in enumerate(args[1]) if t is not None]
        elif packet is aten.embedding:
            index, dims = [args[1]], [0]
        elif packet is aten.index_select:
            index, dims = [args[2]], [args[1] % len(src.spec)]
        else:
            return None
        rest = frozenset().union(*(self.axes_of(e) for i, e in enumerate(src.spec)
                                   if i not in dims)) - self.batch_axes
        return rest.union(*(self.info(t).axes for t in index if t is not None))

    # ------------------------------------------------------------- costs -- #
    def _traffic(self, packet, args, flat_in, flat_out, out_axes) -> None:
        c = self.cost
        if packet in _FULL_READ:
            b = sum(self._per_device(t) for t in flat_in)
            b += sum(_nbytes(t) / self.ways(out_axes) for t in flat_out)
            c.add_traffic("reduce" if packet not in (aten.sort, aten.topk) else "sort", b)
        elif packet in _WINDOW_READ:
            c.add_traffic("gather", 2 * sum(_nbytes(t) for t in flat_out) / self.ways(out_axes))
        elif packet in _WINDOW_WRITE or packet is aten.copy_:
            dst = args[0]
            if packet is aten.copy_:
                if dst.numel() * dst.element_size() >= dst.untyped_storage().nbytes():
                    return  # a whole copy: a layout operation
                upd = args[1]
            else:
                upd = args[_WINDOW_WRITE[packet]]
            if isinstance(upd, torch.Tensor):
                c.add_traffic("scatter", 2 * _nbytes(upd) / self.ways(self.info(dst).axes))

    def _matmul(self, packet, args, kwargs, out) -> frozenset:
        """Dot FLOPs, traffic and tensor-parallel collectives of a product;
        returns the output's axes."""
        c = self.cost
        a, b = (args[1], args[2]) if packet in (aten.addmm, aten.baddbmm) else args[:2]
        ia, ib = self.info(a), self.info(b)
        flops = flop_registry[packet](*args, **kwargs, out_val=out)
        if ib.kind == "param" and ib.spec is not None:
            spec = ib.spec
            k_ax = self.axes_of(spec[-2]) - self.batch_axes
            n_ax = self.axes_of(spec[-1]) - self.batch_axes
            e_ax = self.axes_of(spec[0]) if b.ndim == 3 else frozenset()
            # the activation split along the contracted dim where the weight's
            # rows are whole: gathered first for a weight whose columns take the
            # same axis, else the rows sliced to match (and the output reduced)
            split = ia.axes - self.batch_axes - k_ax - e_ax
            gather, k_ax = split & n_ax, k_ax | (split - n_ax)
            if gather:
                c.add_collective("all-gather", _nbytes(a) / self.ways(ia.axes - gather))
            a_axes = ia.axes - gather
            compute = a_axes | e_ax | k_ax | n_ax
            out_axes = (a_axes - k_ax) | e_ax | n_ax
            a_bytes = _nbytes(a) / self.ways(a_axes)
            b_bytes = _nbytes(b) / self.ways(e_ax | k_ax | n_ax)
            if k_ax:
                c.add_collective("all-reduce", _nbytes(out) / self.ways(out_axes))
            if e_ax & self.batch_axes and ib.leaf.endswith("moe_wi_gate"):
                d_model = self.params[ib.leaf][0].shape[-2]
                buf = a if a.shape[-1] == d_model else out
                c.add_collective("all-to-all", 2 * _nbytes(buf) / self.ways(e_ax), count=2)
        else:
            compute = out_axes = ia.axes | ib.axes
            a_bytes, b_bytes = self._per_device(a), self._per_device(b)
        c.flops += flops / self.ways(compute)
        c.dot_count += 1
        c.add_traffic("dot", a_bytes + b_bytes + _nbytes(out) / self.ways(out_axes))
        return out_axes

    def kernel(self, name: str, dims: dict, inputs: tuple, out_specs: list, backward: bool):
        """A kernel's meta call (``kernels/cost.py``): its outputs, and its
        work at the per-device sizes charged."""
        c = self.cost
        batch = self.batch_axes
        x = inputs[0]
        ix = self.info(x)
        fb = self.ways(ix.axes & batch)
        loc = dict(dims)
        reduce_bytes, reduce_on, out_axes = 0.0, frozenset(), ix.axes
        if name == "flash_attention":
            loc.update(b=_split(dims["b"], fb),
                       hq=_split(dims["hq"], self.ways(ix.axes - batch)),
                       hkv=_split(dims["hkv"], self.ways(self.info(inputs[1]).axes - batch)))
            nbytes, ops = kcost.flash_work(**loc)
            mma = ops
        elif name == "decode_attention":
            spec = self.info(inputs[1]).spec or (None,) * 4
            seq = self.axes_of(spec[1])
            b_loc = _split(dims["b"], self.ways(self.axes_of(spec[0])))
            hq = _split(dims["hq"], self.ways(ix.axes - batch - seq))
            hkv = _split(dims["hkv"], self.ways(self.axes_of(spec[2])))
            keys = kcost.decode_keys(dims["s_max"], dims["window"]) / self.ways(seq)
            nbytes, ops = kcost.decode_work(b_loc, hq, hkv, dims["dh"], keys, dims["size"])
            mma = ops
            out_axes = ix.axes - seq
            if seq:  # the partial softmax's combine: the output and two statistics
                reduce_on = seq
                reduce_bytes = b_loc * hq * (dims["dh"] * dims["size"] + 2 * 4)
        elif name == "swiglu":
            wg, wo = self.info(inputs[1]), self.info(inputs[3])
            f_axes = (self.axes_of(wg.spec[-1]) if wg.spec else wg.axes) - batch
            t = _split(dims["t"], fb)
            nbytes, ops = kcost.swiglu_work(t, dims["d"], _split(dims["f"], self.ways(f_axes)),
                                            dims["size"])
            mma = ops
            reduce_on = (self.axes_of(wo.spec[0]) if wo.spec else frozenset()) - batch
            reduce_bytes = t * dims["d"] * dims["size"]
        else:  # the scans
            loc.update(b=_split(dims["b"], fb), h=_split(dims["h"], self.ways(ix.axes - batch)))
            nbytes, ops, mma = kcost.scan_work(**loc)
            out_axes = frozenset().union(*(self.info(t).axes for t in inputs))
        if backward:
            nbytes, ops, mma = 2 * nbytes, 2 * ops, 2 * mma
        key = name + ("_backward" if backward else "")
        c.kernel_calls[key] = c.kernel_calls.get(key, 0) + 1
        c.flops += mma
        c.add_traffic(name, nbytes)
        if reduce_on and (name != "decode_attention" or not backward):
            c.add_collective("all-reduce", reduce_bytes)
        self._quiet = True
        try:
            outs = tuple(None if s is None else torch.empty(s[0], dtype=s[1], device="meta")
                         for s in out_specs)
        finally:
            self._quiet = False
        for i, t in enumerate(outs):
            if t is not None:
                self._info[t] = _Info(self.info(inputs[i]).axes if backward else out_axes)
                self._track(t)
        return outs

    # --------------------------------------------------- parameter side -- #
    def parameter_collectives(self, train: bool) -> None:
        """FSDP all-gathers (and, training, their reduce-scatters) and
        data-parallel gradient all-reduces, one per layer of each
        registered parameter (see the module docstring)."""
        for name, (t, spec, logical) in self.params.items():
            layers = t.shape[0] if logical[0] == "layers" else 1
            all_axes = frozenset().union(*(self.axes_of(e) for e in spec))
            ep = frozenset().union(*(self.axes_of(e) for e, ax in zip(spec, logical)
                                     if ax == "experts"))
            fsdp = (all_axes - ep) & self.batch_axes
            shard = _nbytes(t) / self.ways(all_axes)
            if fsdp:
                gathered = _nbytes(t) / self.ways(all_axes - fsdp)
                twice = 2 if train else 1  # before the forward use, and the backward's
                self.cost.add_collective("all-gather", gathered * twice, layers * twice)
                if train:
                    self.cost.add_collective("reduce-scatter", shard, layers)
            elif train and not all_axes & self.batch_axes:
                self.cost.add_collective("all-reduce", shard, layers)
