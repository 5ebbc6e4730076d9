"""Shared GNN substrate: batch container, segment message passing, RBF,
MLPs.

The JAX package builds its aggregation on ``jax.ops.segment_sum`` with the
``segment_spmm`` Pallas kernel as the TPU twin.  Here every segment sum on
a CUDA tensor is one launch of the port's ``segment_spmm`` kernel
(``scatter_sum``: a destination-sorted CSR whose source of each slot is the
edge's own row of ``values``; ``gcn.py`` and ``gin.py`` launch it over the
graph's CSR).  On the CPU the plain scatter adds each row's terms in edge
order (``segment_spmm.ref.scatter_add``: ``index_add_``), which is the
kernel's order, so both give the same bits.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import traced
from repro_torch.kernels.segment_spmm.ops import EdgeCSR, csr_from_edges, segment_spmm_csr
from repro_torch.kernels.segment_spmm.ref import scatter_add


@dataclass
class GraphBatch:
    """Padded (possibly batched) graph.

    node_feat: (N, F) float; positions: (N, 3) or None; edge_src/dst: (E,)
    int32 (padded entries masked); graph_id: (N,) int32 for pooled readout;
    targets: (N,) or (G,) — node labels / graph labels / energies.
    """

    node_feat: torch.Tensor
    edge_src: torch.Tensor
    edge_dst: torch.Tensor
    node_mask: torch.Tensor
    edge_mask: torch.Tensor
    targets: torch.Tensor
    positions: Optional[torch.Tensor] = None
    graph_id: Optional[torch.Tensor] = None
    n_graphs: int = 1

    def as_dict(self) -> Dict:
        out = {
            "node_feat": self.node_feat,
            "edge_src": self.edge_src,
            "edge_dst": self.edge_dst,
            "node_mask": self.node_mask,
            "edge_mask": self.edge_mask,
            "targets": self.targets,
        }
        if self.positions is not None:
            out["positions"] = self.positions
        if self.graph_id is not None:
            out["graph_id"] = self.graph_id
        return out


def scatter_sum(values: torch.Tensor, index: torch.Tensor, n: int,
                mask: Optional[torch.Tensor] = None,
                plan: Optional["SumPlan"] = None) -> torch.Tensor:
    """Segment sum with optional edge mask; values (E, ...), index (E,).

    A CUDA tensor goes through the ``segment_spmm`` kernel
    (:func:`scatter_sum_csr`, over ``plan`` when given), and a CPU tensor
    through the plain scatter (:func:`scatter_sum_plain`, which needs no
    plan); both add each row's terms in edge order, from 0, and leave
    masked edges out.  A fake tensor or a DTensor takes the kernel's route
    on any device (``kernels.traced``), so a dry-run counts the kernel's
    work."""
    if values.device.type == "cpu" and not traced(values):
        return scatter_sum_plain(values, index, n, mask)
    return scatter_sum_csr(values, index, n, mask, plan)


def scatter_sum_plain(values: torch.Tensor, index: torch.Tensor, n: int,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain segment sum: masked edges parked in a waste bin, then
    ``scatter_add`` (``index_add_`` on the CPU, the sorted segment sums on
    the card, the same bits)."""
    if mask is not None:
        values = values * mask.reshape((-1,) + (1,) * (values.dim() - 1))
        index = torch.where(mask, index, n)  # park masked edges in a waste bin
        n_bins = n + 1
    else:
        n_bins = n
    return scatter_add(values, index, n_bins)[:n]


@dataclass(frozen=True)
class SumPlan:
    """What :func:`scatter_sum_csr` launches over for one ``(index, n,
    mask)``: a CSR sorted stably by ``index`` whose source of each slot is
    the edge's own id (masked edges parked in a waste row ``n``), and its
    weight per slot, 1 a live edge and 0 a masked one.  A build costs a
    stable sort and one host synchronisation (:class:`EdgeCSR` checks and
    plans its rows), and the backward's transposed CSR is cached on it, so
    build one a set of segments (:func:`sum_plan`) and pass it to every sum
    over them."""

    csr: EdgeCSR
    w: torch.Tensor
    n: int


def sum_plan(index: torch.Tensor, n: int,
             mask: Optional[torch.Tensor] = None) -> SumPlan:
    """The :class:`SumPlan` of ``scatter_sum(., index, n, mask)``, on
    ``index``'s device."""
    E, dev = index.shape[0], index.device
    rows = n
    if mask is not None:
        index = torch.where(mask, index, n)  # park masked edges in a waste row
        rows = n + 1
    csr = csr_from_edges(torch.arange(E, device=dev), index, rows)
    w = (torch.ones(E, dtype=torch.float32, device=dev) if mask is None
         else mask.to(torch.float32)[csr.order].contiguous())
    return SumPlan(csr, w, n)


def scatter_sum_csr(values: torch.Tensor, index: torch.Tensor, n: int,
                    mask: Optional[torch.Tensor] = None,
                    plan: Optional[SumPlan] = None) -> torch.Tensor:
    """The segment sum as one ``segment_spmm_csr`` call over ``plan`` (the
    :func:`sum_plan` of ``index, n, mask``, built here when omitted), with
    ``values`` seen as ``(E, F)`` float32 rows: the kernel skips a slot of
    weight 0, so a masked edge's value, even NaN, never reaches a sum.
    Differentiable in ``values`` (the kernel's backward over the transposed
    CSR)."""
    E, tail = values.shape[0], tuple(values.shape[1:])
    if plan is None:
        plan = sum_plan(index, n, mask)
    elif plan.n != n or plan.w.shape[0] != E:
        raise ValueError(f"scatter_sum_csr: a plan of {plan.w.shape[0]} edges into {plan.n} "
                         f"rows, for {E} values into {n}")
    out = segment_spmm_csr(values.reshape(E, math.prod(tail)).contiguous(), plan.csr, plan.w)
    return unflatten_cols(out[:n], tail)


def unflatten_cols(out: torch.Tensor, tail: Tuple[int, ...]) -> torch.Tensor:
    """``out`` (n, F) as ``(n,) + tail``.  A DTensor whose F columns are
    split over chips in blocks that are not whole ``tail[0]`` slices is
    gathered over those chips first (a view cannot split them)."""
    placements = getattr(out, "placements", None)
    if placements is not None and len(tail) > 1:
        from torch.distributed.tensor import Replicate, Shard

        mesh = out.device_mesh
        cols = [i for i, p in enumerate(placements)
                if isinstance(p, Shard) and p.dim == 1]
        if tail[0] % math.prod(mesh.size(i) for i in cols):
            out = out.redistribute(mesh, [Replicate() if i in cols else p
                                          for i, p in enumerate(placements)])
    return out.reshape((out.shape[0],) + tail)


def row_local(fn: Callable, rows: torch.Tensor, *row_args, shared=()):
    """``fn(*row_args, *shared)`` for a computation that is independent row
    by row over the edges (or nodes) of ``rows`` (a tensor over them, such
    as an index): ``row_args`` have those rows as their first dim,
    ``shared`` (trees of tensors: weights) are read whole by every row.

    On tensors, just the call.  On DTensors, each chip runs ``fn`` on its
    own rows: the row arguments are laid out as ``rows`` is (their rows
    split where ``rows``' are, replicated elsewhere; a tensor among them
    is the whole, on every chip), the shared ones replicated, ``fn`` runs
    on the local tensors, and its output tensors are DTensors of the row
    layout.  A chip's gradient of a shared tensor
    is a partial sum along the mesh dims that split the rows.  (DTensor's
    propagation cannot carry the per-edge products' views and their
    gradients over split rows; the JAX package's GSPMD plan splits these
    products by the same rows.)"""
    placements = getattr(rows, "placements", None)
    if placements is None:
        return fn(*row_args, *shared)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.utils._pytree import tree_map

    mesh = rows.device_mesh
    split = [isinstance(p, Shard) and p.dim == 0 for p in placements]
    fwd = [Shard(0) if s else Replicate() for s in split]
    whole = [Replicate()] * len(split)
    partial = [Partial() if s else Replicate() for s in split]

    def local(lay, grad):
        def go(a):
            if not isinstance(a, torch.Tensor):
                return a
            if not isinstance(a, DTensor):          # the whole, on every chip
                a = DTensor.from_local(a, mesh, whole, run_check=False)
            return a.redistribute(mesh, lay).to_local(grad_placements=grad)
        return go

    out = fn(*(local(fwd, fwd)(a) for a in row_args),
             *tree_map(local(whole, partial), tuple(shared)))

    def wrap(t):
        if not isinstance(t, torch.Tensor):
            return t
        shape = (rows.shape[0],) + tuple(t.shape[1:])
        stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
        return DTensor.from_local(t, mesh, fwd, run_check=False,
                                  shape=shape, stride=stride)

    return tree_map(wrap, out)


def segment_max(values: torch.Tensor, index: torch.Tensor, n: int) -> torch.Tensor:
    """Per-segment maximum, ``-inf`` for an empty segment (as
    ``jax.ops.segment_max``); a maximum is exact in any order."""
    idx = index.long().reshape((-1,) + (1,) * (values.dim() - 1)).expand_as(values)
    out = torch.full((n,) + tuple(values.shape[1:]), -math.inf,
                     dtype=values.dtype, device=values.device)
    return out.scatter_reduce(0, idx, values, "amax", include_self=False)


def degrees(edge_dst: torch.Tensor, n: int,
            edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """In-degrees as float32, masked edges left out: a count, exact in any
    order, so one integer ``index_add_`` serves every device (no sort; its
    output's shape follows from ``n``, so a fake run can count it)."""
    index = edge_dst.long()
    if edge_mask is not None:
        index = torch.where(edge_mask, index, n)
    counts = torch.zeros(n + 1, dtype=torch.int64, device=index.device)
    counts = counts.index_add(0, index, torch.ones_like(index))
    return counts[:n].to(torch.float32)


def gather(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    return x.index_select(0, index.long())


def segment_softmax(logits: torch.Tensor, index: torch.Tensor, n: int,
                    mask: Optional[torch.Tensor] = None,
                    plan: Optional[SumPlan] = None) -> torch.Tensor:
    """Per-destination softmax over edges; logits (E, ...), index (E,).
    The denominator is a :func:`scatter_sum` (the kernel on the card, over
    ``plan``, the :func:`sum_plan` of ``index, n, mask``: it skips the
    masked edges, whose terms are 0 here, so the sum keeps the bits of the
    reference's unmasked one)."""
    big_neg = -1e30
    shape = (-1,) + (1,) * (logits.dim() - 1)
    if mask is not None:
        logits = torch.where(mask.reshape(shape), logits, big_neg)
    seg_max = segment_max(logits, index, n)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    ex = torch.exp(logits - gather(seg_max, index))
    if mask is not None:
        ex = ex * mask.reshape(shape)
    denom = scatter_sum(ex, index, n, plan=plan)
    return ex / torch.clamp(gather(denom, index), min=1e-30)


def bessel_rbf(dist: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """Bessel radial basis with polynomial cutoff envelope (NequIP-style)."""
    d = torch.clamp(dist, min=1e-6)[..., None]
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=dist.device)
    basis = math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * d / cutoff) / d
    x = torch.clamp(dist / cutoff, 0.0, 1.0)[..., None]
    env = 1.0 - 10.0 * x ** 3 + 15.0 * x ** 4 - 6.0 * x ** 5
    return basis * env


def mlp_init(dims: Sequence[int], generator: torch.Generator,
             device: torch.device, dtype=torch.float32) -> List[Dict]:
    """Dense layers ``w ~ N(0, 1/a)``, ``b = 0`` for consecutive ``dims``."""
    params = []
    for a, b in zip(dims, dims[1:]):
        w = torch.randn((a, b), generator=generator, device=device) / math.sqrt(a)
        params.append({"w": w.to(dtype),
                       "b": torch.zeros((b,), dtype=dtype, device=device)})
    return params


def mlp_apply(params, x, act=F.silu, final_act=False):
    for i, p in enumerate(params):
        x = x @ p["w"] + p["b"]
        if i < len(params) - 1 or final_act:
            x = act(x)
    return x


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def edge_geometry(batch: Dict, cutoff: float):
    """The equivariant models' edge vectors ``r = pos[src] - pos[dst]``,
    their lengths, and the edge mask less the edges at or past
    ``cutoff``."""
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    r = gather(batch["positions"], src) - gather(batch["positions"], dst)
    dist = torch.linalg.norm(r + 1e-9, dim=-1)
    return r, dist, batch["edge_mask"] & (dist < cutoff)


def message_plans(batch: Dict, emask: torch.Tensor,
                  n_graphs: int) -> Dict[str, Optional[SumPlan]]:
    """The equivariant models' plans, one a set of segments: ``"messages"``
    into their destinations under ``emask`` (:func:`edge_geometry`'s) and
    ``"pool"``, the atoms' energies into their graphs (None without
    ``graph_id``)."""
    gid = batch.get("graph_id")
    return {"messages": sum_plan(batch["edge_dst"].long(), batch["node_feat"].shape[0], emask),
            "pool": None if gid is None else sum_plan(gid.long(), n_graphs)}
