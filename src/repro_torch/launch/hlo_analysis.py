"""Cost analysis of a fake-tensor run: FLOPs by type, bytes, peak memory,
collective traffic, and the roofline terms of one NVIDIA H100 SXM5.

The JAX package's ``launch/hlo_analysis.py`` reads a compiled XLA
executable (``cost_analysis()``, ``memory_analysis()`` and its HLO text).
This module keeps its name so that its twin can be found, but it analyses
no HLO: it runs a cell's step once on fake tensors
(``torch._subclasses.fake_tensor.FakeTensorMode``: shapes and types, no
memory, no kernels), as DTensors over a fake process group when the mesh
has several chips, and counts what each device runs under a
``TorchDispatchMode`` (:class:`CountingMode`) that sees the aten ops and the
kernels' custom ops on each device's local shards (it lets DTensor
dispatch first, as ``torch.distributed.tensor.debug.CommDebugMode``
does, so it counts the local shard's work, not the global op's):

  FLOPs          ``torch.utils.flop_counter``'s formulas (the products;
                 elementwise work is not counted), the kernels' own
                 formulas (``kernels/*/ops.py``), by the first input's type;
  bytes accessed each op's operands plus results (views move nothing);
  compulsory     every new output written once, every argument that some
  bytes          op reads in full, and the bytes written into arguments in
                 place (at most each argument's size: a decode step writes
                 one slot of its cache); a tensor read only through an index
                 (``embedding``, ``index_select``, ``gather``, advanced
                 indexing, the kernels' gathers) counts its indices (when
                 they are arguments), not itself;
  temp bytes     the peak of the storages allocated during the step and
                 still alive (a storage dies when its last tensor does,
                 autograd's saved tensors included): with the arguments, a
                 floor on the card's peak, which adds the caching
                 allocator's rounding and the libraries' workspaces;
  collectives    the functional collectives that DTensor calls, by the
                 result's bytes (the JAX package's rule):

    all-gather          1x result bytes   (each chip receives ~the full result)
    all-reduce          2x result bytes   (reduce-scatter + all-gather phases)
    reduce-scatter      1x result bytes
    all-to-all          1x result bytes
    collective-permute  1x result bytes

Hardware model: an NVIDIA H100 SXM5's published dense peaks
(https://www.nvidia.com/en-us/data-center/h100/, not fetched): 989.4
TFLOP/s for bf16 / fp16 products, 494.7 TFLOP/s TF32, the floor used for
float32 products whatever implements them (three TF32 products or the
CUDA cores), 1,978.9 for fp8 / int8, 66.9 for fp64; HBM3 at 3.35 TB/s;
NVLink 4 at 450 GB/s a direction.  Like the JAX package's single ICI link,
one NVLink is modelled; cross-node InfiniBand is not.

The roofline's two departures from the JAX package's (``Roofline``):
``compute_s`` sums each type's FLOPs over that type's peak, and
``memory_s`` reads the compulsory bytes, not the per-op sum, so that the
roofline is a floor that no correct implementation, fused or not, can beat.
"""
from __future__ import annotations

import math
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989.4e12        # bf16 / fp16 dense products, per chip
PEAK_TF32 = 494.7e12         # TF32 dense: the float32 products' floor
HBM_BW = 3.35e12             # bytes/s per chip, HBM3
LINK_BW = 450e9              # bytes/s per NVLink 4 direction

#: dense peak (FLOP/s) by the products' input type; other types read PEAK_FLOPS
PEAK_BY_DTYPE = {
    "bfloat16": PEAK_FLOPS,
    "float16": PEAK_FLOPS,
    "float32": PEAK_TF32,
    "float8_e4m3fn": 1978.9e12,
    "float8_e5m2": 1978.9e12,
    "int8": 1978.9e12,
    "float64": 66.9e12,
}

#: what the records say of the card
HARDWARE = {
    "name": "NVIDIA H100 SXM5 80GB",
    "source": "https://www.nvidia.com/en-us/data-center/h100/ (published peaks, not fetched)",
    "peak_flops": PEAK_BY_DTYPE,
    "hbm_bytes_per_s": HBM_BW,
    "link_bytes_per_s": LINK_BW,
    "hbm_bytes": 80e9,
    "links": "one NVLink 4 direction; cross-node InfiniBand not modelled",
}

_WIRE_MULT = {
    "all-gather": 1.0,
    "all-reduce": 2.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

#: ``_c10d_functional`` ops (what DTensor calls) by the JAX package's names
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "all-gather",
}

#: aten ops that read an input only through an index: schema name -> positions
_GATHERS = {
    "aten::embedding": (0,),
    "aten::index_select": (0,),
    "aten::gather": (0,),
    "aten::index": (0,),
    "aten::_unsafe_index": (0,),
    "aten::take": (0,),
}


def _written_args(func) -> Tuple[int, ...]:
    """Positions of the arguments that an op writes (in-place or ``out=``):
    written, not read."""
    return tuple(i for i, a in enumerate(func._schema.arguments)
                 if a.alias_info is not None and a.alias_info.is_write)


def _gathered(func) -> Tuple[int, ...]:
    from repro_torch.kernels import GATHERED_INPUTS

    name = func._schema.name
    return _GATHERS.get(name) or GATHERED_INPUTS.get(name, ())


@dataclass
class CollectiveStats:
    bytes_by_op: Dict[str, float] = field(default_factory=dict)
    count_by_op: Dict[str, int] = field(default_factory=dict)
    wire_bytes: float = 0.0

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_op.values())


def collective_bytes(records: Iterable[Tuple[str, float]]) -> CollectiveStats:
    """Sum ``(op, result bytes)`` records, each op by its wire multiplier."""
    stats = CollectiveStats()
    for op, nbytes in records:
        stats.bytes_by_op[op] = stats.bytes_by_op.get(op, 0.0) + nbytes
        stats.count_by_op[op] = stats.count_by_op.get(op, 0) + 1
        stats.wire_bytes += nbytes * _WIRE_MULT[op]
    return stats


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def local(t):
    """A DTensor's local shard, or the tensor itself."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


class CountingMode(TorchDispatchMode):
    """Counts what one device runs (see the module docstring).  ``args``
    are the step's arguments (local tensors): their storages are neither
    temporaries nor compulsory until some op reads them in full."""

    def __init__(self, args: Iterable[torch.Tensor] = ()):
        super().__init__()
        self.flops: Dict[str, float] = {}
        self.bytes_accessed = 0.0
        self.collectives: List[Tuple[str, float]] = []
        self.n_ops = 0
        self._args: Dict[int, Tuple[Any, int]] = {}   # id(storage) -> (storage, bytes)
        for t in args:
            st = t.untyped_storage()
            self._args[id(st)] = (st, st.nbytes())
        self._read: Dict[int, int] = {}                # args read in full
        self._written: Dict[int, int] = {}             # bytes written into args
        self._live: Dict[int, Tuple[weakref.ref, int]] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._propagating = 0

    # DTensor works out an op's global output shapes by running it on fake
    # tensors (``ShardingPropagator._propagate_tensor_meta*``); those runs
    # are no device's work, so counting is off inside them
    _META_PROPAGATION = ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        mode, self._patched = self, []
        for name in self._META_PROPAGATION:
            orig = ShardingPropagator.__dict__.get(name)
            if orig is None:
                continue

            def guarded(prop, *args, _orig=orig, **kwargs):
                mode._propagating += 1
                try:
                    return _orig(prop, *args, **kwargs)
                finally:
                    mode._propagating -= 1

            setattr(ShardingPropagator, name, guarded)
            self._patched.append((name, orig))
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        for name, orig in self._patched:
            setattr(ShardingPropagator, name, orig)
        return super().__exit__(*exc)

    def _mark_read(self, tensors) -> None:
        for t in tensors:
            key = id(t.untyped_storage())
            if key in self._args:
                self._read[key] = self._args[key][1]

    def _free(self, key: int, ref) -> None:
        entry = self._live.get(key)
        if entry is not None and entry[0] is ref:
            del self._live[key]
            self.live_bytes -= entry[1]

    def _allocated(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._args or key in self._live:
            return
        nbytes = st.nbytes()
        ref = weakref.ref(st, lambda r, key=key: self._free(key, r))
        self._live[key] = (ref, nbytes)
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # let DTensor lower it to local ops
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if (self._propagating or not isinstance(func, torch._ops.OpOverload)
                or not outs):       # metadata queries (prim.device, sizes) move nothing
            return out
        self.n_ops += 1
        if func.namespace == "_c10d_functional":
            op = _COLLECTIVE_OPS.get(func._overloadpacket.__name__)
            if op is not None:
                self.collectives.append((op, float(sum(_nbytes(t) for t in outs))))
                self._mark_read(_tensors(args))   # a chip sends what it holds
            return out
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            ins = _tensors((args, kwargs))
            dtype = str(ins[0].dtype).replace("torch.", "") if ins else "float32"
            self.flops[dtype] = self.flops.get(dtype, 0.0) + float(
                formula(*args, **kwargs, out_val=out))
        if getattr(func, "is_view", False):
            return out
        skip = _gathered(func) + _written_args(func)
        for i, a in enumerate(args):
            ts = _tensors(a)
            self.bytes_accessed += sum(_nbytes(t) for t in ts)
            if i not in skip:
                self._mark_read(ts)
        for t in _tensors(kwargs):
            self.bytes_accessed += _nbytes(t)
        for t in outs:
            self.bytes_accessed += _nbytes(t)
            key = id(t.untyped_storage())
            if key in self._args:           # an in-place write into an argument
                self._written[key] = min(self._args[key][1],
                                         self._written.get(key, 0) + _nbytes(t))
            else:
                self._allocated(t)
        return out

    @property
    def args_read_bytes(self) -> int:
        return sum(self._read.values())


@dataclass
class FakeRun:
    """What one device ran in a step (see :class:`CountingMode`)."""

    flops_by_dtype: Dict[str, float]
    bytes_accessed: float
    compulsory_bytes: float
    argument_bytes: int
    output_bytes: int
    alias_bytes: int
    temp_bytes: int
    collectives: List[Tuple[str, float]]
    n_ops: int

    @property
    def flops(self) -> float:
        return sum(self.flops_by_dtype.values())


#: the fake tensors' device.  The kernel wrappers take their custom ops'
#: route on fake tensors of any device, so the count is the card's path;
#: "cpu", because autograd on fake CUDA tensors aborts a CPU-only build
FAKE_DEVICE = "cpu"


def _placed(leaf, sharding, mesh):
    """A fake tensor for the meta tensor ``leaf``: plain on a one-chip mesh
    or without a sharding, else a DTensor of ``sharding``'s placements
    whose local shard is rank 0's."""
    from torch.distributed.tensor import DTensor, Shard

    global_shape = tuple(leaf.shape)
    if sharding is None or mesh is None or _chips(mesh) == 1:
        return torch.empty(global_shape, dtype=leaf.dtype, device=FAKE_DEVICE)
    shape = list(global_shape)
    sizes = list(_axis_sizes(mesh).values())
    for size, pl in zip(sizes, sharding.placements):
        if isinstance(pl, Shard):
            shape[pl.dim] = math.ceil(shape[pl.dim] / size)
    t = torch.empty(shape, dtype=leaf.dtype, device=FAKE_DEVICE)
    stride = torch.empty(global_shape, device="meta").stride()
    return DTensor.from_local(t, mesh, sharding.placements, run_check=False,
                              shape=global_shape, stride=stride)


def _axis_sizes(mesh) -> Dict[str, int]:
    from repro_torch.distributed.sharding import mesh_axis_sizes

    return mesh_axis_sizes(mesh)


def _chips(mesh) -> int:
    return math.prod(_axis_sizes(mesh).values()) if mesh is not None else 1


def _zip(tree, shardings, fn):
    """``fn(leaf, sharding)`` over ``tree``, where ``shardings`` is a tree of
    its structure or a prefix of it (a None or single sharding covers a
    whole subtree)."""
    if isinstance(tree, dict):
        return {k: _zip(v, shardings.get(k) if isinstance(shardings, dict) else shardings, fn)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            _zip(v, shardings[i] if isinstance(shardings, (list, tuple)) else shardings, fn)
            for i, v in enumerate(tree))
    return fn(tree, shardings)


def fake_arguments(plan, mode):
    """The plan's arguments as fake tensors of ``mode``: each a DTensor laid
    out by its input sharding on a mesh of several chips."""
    with mode:
        return _zip(plan.args, plan.in_shardings,
                    lambda leaf, sh: _placed(leaf, sh, plan.mesh)
                    if isinstance(leaf, torch.Tensor) else leaf)


def _lay_out(out, shardings):
    """Outputs redistributed to their output shardings (DTensors only)."""
    from torch.distributed.tensor import DTensor

    def put(t, sh):
        if isinstance(t, DTensor) and sh is not None and tuple(t.placements) != tuple(sh.placements):
            return t.redistribute(t.device_mesh, sh.placements)
        return t

    return _zip(out, shardings, put)


#: aten ops that the port's steps run and DTensor has no sharding rule for;
#: a dry-run gives them one that takes every input replicated (DTensor then
#: all-gathers a sharded input first, and the count shows that)
_REPLICATED_OPS = ("searchsorted.Tensor", "segment_reduce.default",
                   "_segment_reduce_backward.default", "index_copy.default",
                   "index_add.default", "scatter_reduce.two")
_registered = []


def _replicated_rules() -> None:
    """Register :data:`_REPLICATED_OPS`' rules, once, for ops that still
    have none (a later torch may bring its own)."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor.experimental import register_sharding

    if _registered:
        return
    prop = DTensor._op_dispatcher.sharding_propagator
    for name in _REPLICATED_OPS:
        packet, overload = name.split(".")
        op = getattr(getattr(torch.ops.aten, packet), overload)
        known = (getattr(prop, name, {}) for name in
                 ("op_strategy_funcs", "op_to_rules", "op_single_dim_strategy_funcs"))
        if any(op in k for k in known):
            continue
        n_out = len(op._schema.returns)

        def rule(*args, n_out=n_out, **kwargs):
            ins = [Replicate() if isinstance(a, DTensorSpec) else None for a in args]
            return [([Replicate()] * n_out, ins)]

        register_sharding(op)(rule)
    _registered.append(True)


def run_fake(plan) -> FakeRun:
    """Run ``plan.step_fn`` once on fake arguments and count one device's
    work (the plan's mesh gives the local shards)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    _replicated_rules()
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    args = fake_arguments(plan, mode)
    arg_locals = [local(t) for t in _tensors(args)]
    counter = CountingMode(arg_locals)
    # tensors the step makes itself (positions, index tables) join the
    # DTensors as replicated
    from torch.distributed.tensor.experimental import implicit_replication

    with mode, counter, implicit_replication():
        out = plan.step_fn(*args)
        out = _lay_out(out, plan.out_shardings)
    arg_keys = {id(t.untyped_storage()) for t in arg_locals}
    outputs: Dict[int, int] = {}
    for t in _tensors(out):
        t = local(t)
        key = id(t.untyped_storage())
        outputs[key] = max(outputs.get(key, 0), _nbytes(t))
    new = sum(b for k, b in outputs.items() if k not in arg_keys)
    return FakeRun(
        flops_by_dtype=dict(counter.flops),
        bytes_accessed=counter.bytes_accessed,
        compulsory_bytes=float(counter.args_read_bytes + new
                               + sum(counter._written.values())),
        argument_bytes=sum({id(t.untyped_storage()): _nbytes(t) for t in arg_locals}.values()),
        output_bytes=sum(outputs.values()),
        alias_bytes=sum(b for k, b in outputs.items() if k in arg_keys),
        temp_bytes=counter.peak_bytes,
        collectives=list(counter.collectives),
        n_ops=counter.n_ops,
    )


@dataclass
class Roofline:
    flops_per_device: float
    hbm_bytes_per_device: float
    collective_wire_bytes: float
    model_flops_total: float
    n_chips: int
    #: FLOPs per device by the products' type; without it every FLOP runs
    #: at ``PEAK_FLOPS``, as in the JAX package
    flops_by_dtype: Optional[Dict[str, float]] = None

    @property
    def compute_s(self) -> float:
        if self.flops_by_dtype is None:
            return self.flops_per_device / PEAK_FLOPS
        return sum(f / PEAK_BY_DTYPE.get(dt, PEAK_FLOPS)
                   for dt, f in self.flops_by_dtype.items())

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_wire_bytes / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (counted flops across chips) — remat/redundancy waste."""
        total = self.flops_per_device * self.n_chips
        return self.model_flops_total / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of peak sustained if the step ran at the roofline time:
        useful compute seconds / roofline step seconds."""
        useful_s = self.model_flops_total / (self.n_chips * PEAK_FLOPS)
        return useful_s / self.step_time_s if self.step_time_s else 0.0

    def to_dict(self) -> Dict:
        return {
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "collective_wire_bytes": self.collective_wire_bytes,
            "model_flops_total": self.model_flops_total,
            "n_chips": self.n_chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "step_time_s": self.step_time_s,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def analyze(run: FakeRun, model_flops_total: float, n_chips: int) -> Dict:
    """The per-cell analysis dict of a fake run, under the JAX package's
    keys: ``cost_analysis`` (``flops``, ``flops <type>``, ``bytes
    accessed``, ``compulsory bytes``), ``memory_analysis``,
    ``collectives`` and ``roofline``."""
    coll = collective_bytes(run.collectives)
    roof = Roofline(
        flops_per_device=run.flops,
        hbm_bytes_per_device=run.compulsory_bytes,
        collective_wire_bytes=coll.wire_bytes,
        model_flops_total=model_flops_total,
        n_chips=n_chips,
        flops_by_dtype=run.flops_by_dtype,
    )
    cost = {"flops": run.flops, "bytes accessed": run.bytes_accessed,
            "compulsory bytes": run.compulsory_bytes, "ops": float(run.n_ops)}
    cost.update({f"flops {dt}": f for dt, f in run.flops_by_dtype.items()})
    return {
        "cost_analysis": cost,
        "memory_analysis": {
            "argument_size_in_bytes": int(run.argument_bytes),
            "output_size_in_bytes": int(run.output_bytes),
            "temp_size_in_bytes": int(run.temp_bytes),
            "generated_code_size_in_bytes": 0,
            "alias_size_in_bytes": int(run.alias_bytes),
        },
        "collectives": {
            "bytes_by_op": coll.bytes_by_op,
            "count_by_op": coll.count_by_op,
            "wire_bytes": coll.wire_bytes,
        },
        "roofline": roof.to_dict(),
    }
