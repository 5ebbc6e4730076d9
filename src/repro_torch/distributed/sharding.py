"""Logical-axis sharding rules (MaxText/t5x style), over a ``DeviceMesh``.

The JAX package's ``distributed/sharding.py``: model code names every
tensor dimension with a *logical* axis; the launch layer resolves names to
mesh axes per deployment.  Parameters use the ``fsdp`` name on their
largest dim (ZeRO-3: parameters and optimizer state fully sharded over the
data axis) and ``model`` on the tensor-parallel dim.

Defaults:

  single pod  (16, 16)   -> ("data", "model")
  multi-pod   (2, 16, 16) -> ("pod", "data", "model");
    batch over (pod, data); parameters replicated across pods.

:meth:`LogicalAxisRules.spec` gives the JAX package's ``PartitionSpec`` as
a tuple (an entry a tensor dim: ``None``, a mesh axis name, or a tuple of
names).  A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
named dims (``launch/mesh.py``), or anything with a ``shape`` dict of axis
sizes.  :func:`logical_to_sharding` turns a spec into
``torch.distributed.tensor`` placements, one a mesh dim: ``Shard(i)`` where
the spec puts that mesh axis on tensor dim ``i`` (a dim over several mesh
axes is split by them in mesh-dim order, major first, as the meshes here
list them in the rules' order), else ``Replicate()``.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

Axis = Union[str, Tuple[str, ...], None]
Spec = Tuple[Axis, ...]


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a named ``DeviceMesh`` or of an object with
    a ``shape`` dict (the JAX package's ``Mesh.shape``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.mesh.shape))
    return dict(mesh.shape)


# ---------------------------------------------------------------------------
# activation sharding constraints
#
# Model code may call ``constrain(x, "batch", None, ...)`` on intermediates.
# Outside a launch context this is a no-op (CPU tests see plain tensors);
# inside ``activation_sharding(mesh)`` it lays ``x`` out as a DTensor.
# ---------------------------------------------------------------------------

_ACT_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "activation_sharding", default=None)


@contextlib.contextmanager
def activation_sharding(mesh, rules: Optional["LogicalAxisRules"] = None):
    token = _ACT_CTX.set((mesh, rules or rules_for(mesh)))
    try:
        yield
    finally:
        _ACT_CTX.reset(token)


def constrain(x, *logical_axes, shape: Optional[Sequence[int]] = None):
    """``x`` laid out by logical names (a DTensor redistributed, a tensor
    distributed from this rank's copy); no-op without context.  The
    divisibility fallback reads ``shape`` when given (a split dim's head
    count, say), else ``x``'s own."""
    ctx = _ACT_CTX.get()
    if ctx is None:
        return x
    mesh, rules = ctx
    shape = tuple(x.shape) if shape is None else tuple(shape)
    return logical_to_sharding(mesh, logical_axes, rules, shape).apply(x)


@dataclass(frozen=True)
class LogicalAxisRules:
    rules: Tuple[Tuple[str, Axis], ...]

    def lookup(self, name: Optional[str]) -> Axis:
        if name is None:
            return None
        for k, v in self.rules:
            if k == name:
                return v
        return None

    def spec(self, logical_axes: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None, mesh=None) -> Spec:
        """Resolve logical names to a spec (the ``PartitionSpec``'s entries).

        When ``shape`` and ``mesh`` are given, mesh axes that do not divide
        the dimension are dropped (trailing-first), falling back to
        replication — the standard divisibility guard.  A mesh axis appears
        at most once; trailing ``None`` entries are trimmed."""
        sizes = mesh_axis_sizes(mesh) if mesh is not None else None
        seen = []
        out = []
        for i, name in enumerate(logical_axes):
            ax = self.lookup(name)
            if ax is None:
                out.append(None)
                continue
            flat = (ax,) if isinstance(ax, str) else tuple(ax)
            flat = tuple(a for a in flat if a not in seen)
            if shape is not None and sizes is not None:
                dim = shape[i]
                while flat:
                    prod = 1
                    for a in flat:
                        prod *= sizes[a]
                    if dim % prod == 0:
                        break
                    flat = flat[:-1]
            seen.extend(flat)
            if not flat:
                out.append(None)
            elif len(flat) == 1:
                out.append(flat[0])
            else:
                out.append(flat)
        while out and out[-1] is None:
            out.pop()
        return tuple(out)


SINGLE_POD_RULES = LogicalAxisRules((
    ("batch", ("data",)),
    ("fsdp", ("data",)),
    ("model", ("model",)),
    ("experts", ("model",)),
    ("vocab", ("model",)),
    ("heads", ("model",)),
    ("kv_heads", ("model",)),
    ("ffn", ("model",)),
    # KV-cache sequence: takes whatever axes the array hasn't used yet
    # (batched decode -> model only; batch-1 long decode -> data+model)
    ("kv_seq", ("data", "model")),
    ("nodes", ("data",)),       # GNN node dim
    ("edges", ("data",)),
    ("rows", ("model",)),       # embedding-table rows
    ("candidates", ("model",)),
    ("feat_model", ("model",)),
))

MULTI_POD_RULES = LogicalAxisRules((
    ("batch", ("pod", "data")),
    ("fsdp", ("data",)),
    ("model", ("model",)),
    ("experts", ("model",)),
    ("vocab", ("model",)),
    ("heads", ("model",)),
    ("kv_heads", ("model",)),
    ("ffn", ("model",)),
    ("kv_seq", ("pod", "data", "model")),
    ("nodes", ("pod", "data")),
    ("edges", ("pod", "data")),
    ("rows", ("model",)),
    ("candidates", ("model",)),
    ("feat_model", ("model",)),
))


def rules_for(mesh) -> LogicalAxisRules:
    return MULTI_POD_RULES if "pod" in mesh_axis_sizes(mesh) else SINGLE_POD_RULES


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh and its ``torch.distributed.tensor`` placements."""

    mesh: object
    spec: Spec
    placements: Tuple

    def apply(self, x):
        """``x`` as a DTensor with these placements: a DTensor
        redistributed, a tensor distributed from this rank's copy."""
        from torch.distributed.tensor import DTensor, distribute_tensor

        if isinstance(x, DTensor):
            return x.redistribute(self.mesh, self.placements)
        return distribute_tensor(x, self.mesh, self.placements)


def placements_for(mesh, spec: Spec) -> Tuple:
    """One placement a mesh dim: ``Shard(i)`` where ``spec`` puts the mesh
    axis on tensor dim ``i``, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    dim_of = {}
    for i, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            dim_of[a] = i
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in mesh_axis_sizes(mesh))


def logical_to_sharding(
    mesh,
    logical_axes: Sequence[Optional[str]],
    rules: Optional[LogicalAxisRules] = None,
    shape: Optional[Sequence[int]] = None,
) -> NamedSharding:
    rules = rules or rules_for(mesh)
    spec = rules.spec(logical_axes, shape, mesh)
    return NamedSharding(mesh, spec, placements_for(mesh, spec))


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def tree_shardings(mesh, logical_tree, shapes_tree=None,
                   rules: Optional[LogicalAxisRules] = None):
    """Map a tree (nested dicts and lists) of logical-axis tuples to
    :class:`NamedSharding` leaves.  With ``shapes_tree`` (a tree of the same
    structure whose leaves have a ``shape``: tensors, or ``()`` for a
    scalar), applies the divisibility fallback."""
    rules = rules or rules_for(mesh)

    def walk(axes, shapes):
        if _is_axes(axes):
            shape = None if shapes_tree is None else tuple(getattr(shapes, "shape", ()))
            return logical_to_sharding(mesh, axes, rules, shape)
        if isinstance(axes, dict):
            return {k: walk(v, None if shapes is None else shapes[k])
                    for k, v in axes.items()}
        if isinstance(axes, (list, tuple)):
            return type(axes)(walk(v, None if shapes is None else shapes[i])
                              for i, v in enumerate(axes))
        raise TypeError(f"not a logical-axis tree node: {axes!r}")

    return walk(logical_tree, shapes_tree)
