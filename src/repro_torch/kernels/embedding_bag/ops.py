"""Wrapper of the ``embedding_bag`` kernel and of its backward: argument
checks, the launch counts, and the choice between the kernels (CUDA
tensors) and their plain versions (CPU tensors).

Fake tensors and DTensors (``kernels.traced``) go through the
custom ops ``repro_torch::embedding_bag`` and
``repro_torch::embedding_bag_backward``: their fake route returns empty
outputs, their FLOP formulas count an add per slot and column, and their
sharding rule takes the inputs replicated, the bags split by rows, or the
columns split."""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import GATHERED_INPUTS, LAUNCH_LOCK, sharding_rules, traced
from repro_torch.kernels.embedding_bag.ref import (
    bag_gradient, embedding_bag_backward_reference, embedding_bag_reference)

COMBINERS = ("sum", "mean")
#: the backward's rows with more slots than this go to its long-row kernel
#: (a producer warp feeding the row's distinct gathers through a ring in
#: shared memory to a thread a column), launched ahead of the rest
LONG_SLOTS = 32


def _check(table: torch.Tensor, ids: torch.Tensor, combiner: str) -> None:
    if combiner not in COMBINERS:
        raise ValueError(f"embedding_bag: combiner must be one of {COMBINERS}, "
                         f"got {combiner!r}")
    if ids.device != table.device:
        raise ValueError(f"embedding_bag: ids are on {ids.device}, "
                         f"the table on {table.device}")
    if table.dtype != torch.float32 or table.dim() != 2:
        raise ValueError(f"embedding_bag: table must be 2-D float32, got "
                         f"{table.dim()}-D {table.dtype}")
    if ids.dtype != torch.int32 or ids.dim() != 2:
        raise ValueError(f"embedding_bag: ids must be 2-D int32, got "
                         f"{ids.dim()}-D {ids.dtype}")
    if not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError("embedding_bag: table and ids must be contiguous")
    if ids.shape[0] >= 2**31 or table.shape[1] >= 2**31:
        raise ValueError("embedding_bag: the kernel takes fewer than 2**31 "
                         "bags and columns")


def _forward(table: torch.Tensor, ids: torch.Tensor, combiner: str) -> torch.Tensor:
    if traced(table, ids):
        return _bag_op(table, ids, combiner == "mean")
    return _launch(table, ids, combiner)


def _launch(table: torch.Tensor, ids: torch.Tensor, combiner: str) -> torch.Tensor:
    if table.device.type == "cpu":
        return embedding_bag_reference(table, ids, combiner)
    if table.device.type != "cuda":
        raise ValueError(f"embedding_bag: no kernel for device {table.device}")
    from repro_torch.kernels.embedding_bag.kernel import embedding_bag_cuda

    out = embedding_bag_cuda(table, ids, combiner == "mean")
    with LAUNCH_LOCK:
        embedding_bag.launches += 1
    return out


class _EmbeddingBag(torch.autograd.Function):
    """The bag kernel and, for the table's gradient,
    ``embedding_bag_backward`` as one differentiable function; the ids
    take no gradient."""

    @staticmethod
    def forward(ctx, table, ids, combiner):
        ctx.save_for_backward(ids)
        ctx.V, ctx.combiner = table.shape[0], combiner
        return _forward(table, ids, combiner)

    @staticmethod
    def backward(ctx, g_out):
        (ids,) = ctx.saved_tensors
        return embedding_bag_backward(g_out, ids, ctx.V, ctx.combiner), None, None


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  combiner: str = "sum") -> torch.Tensor:
    """``(B, d)`` bag sums (or means, over all H slots) of ``table`` rows.

    ``table`` is ``(V, d)`` float32 and ``ids`` ``(B, H)`` int32 global row
    ids; an id outside ``[0, V)`` (for example a -1 pad) adds nothing.
    CUDA tensors go to the hand-written kernel (``csrc/embedding_bag.cu``),
    CPU tensors to the plain version.  When autograd records and the table
    requires grad, the output has a ``grad_fn`` whose backward is
    ``embedding_bag_backward`` (a dense ``(V, d)`` table gradient).
    """
    _check(table, ids, combiner)
    if torch.is_grad_enabled() and table.requires_grad:
        return _EmbeddingBag.apply(table, ids, combiner)
    return _forward(table, ids, combiner)


#: kernel launches since the last reset (CPU calls do not count)
embedding_bag.launches = 0


def embedding_bag_backward(g_out: torch.Tensor, ids: torch.Tensor, V: int,
                           combiner: str = "sum") -> torch.Tensor:
    """The table's dense ``(V, d)`` gradient of ``embedding_bag`` for the
    output gradient ``g_out`` (B, d): row r sums, in slot order (b, h) from
    0, the ``bag_gradient`` (``g_out``, divided by H for ``mean``) of every
    slot whose id is r; ids outside ``[0, V)`` add nothing; rows no id
    names are 0.

    On CUDA tensors the sums run in the hand-written backward kernel
    (``csrc/embedding_bag_bwd.cu``) over a CSR whose rows are table rows and
    whose entries are the valid slots' bags, sorted stably by id (a
    ``torch.sort`` before the launch): each table row is owned and written
    once, by the rows kernel or, past ``LONG_SLOTS`` slots, by the long-row
    kernel launched ahead of it; empty rows are 0; no atomics, and no
    device-to-host sync.  CPU tensors go to the plain version."""
    B, H = ids.shape
    if g_out.shape != (B, g_out.shape[1]) or g_out.dim() != 2 or g_out.device != ids.device:
        raise ValueError(f"embedding_bag_backward: g_out must be ({B}, d) on the ids' "
                         f"device, got {tuple(g_out.shape)} on {g_out.device}")
    if combiner not in COMBINERS:
        raise ValueError(f"embedding_bag_backward: combiner must be one of {COMBINERS}")
    if traced(g_out, ids):
        return _bag_backward_op(g_out, ids, V, combiner == "mean")
    return _launch_backward(g_out, ids, V, combiner)


def _launch_backward(g_out: torch.Tensor, ids: torch.Tensor, V: int,
                     combiner: str) -> torch.Tensor:
    B, H = ids.shape
    if g_out.device.type == "cpu":
        return embedding_bag_backward_reference(g_out, ids, V, combiner)
    if g_out.device.type != "cuda":
        raise ValueError(f"embedding_bag_backward: no kernel for device {g_out.device}")
    if B * H >= 2**31 or V >= 2**31 - 1:
        raise ValueError("embedding_bag_backward: the CSR's int32 offsets take fewer "
                         "than 2**31 slots and rows")
    from repro_torch.kernels.embedding_bag.kernel import embedding_bag_backward_cuda

    g = bag_gradient(g_out, H, combiner)
    row_ptr, bag, runs = slot_csr(ids, V)
    out = embedding_bag_backward_cuda(g, row_ptr, bag, runs, long_rows(row_ptr, B * H),
                                      LONG_SLOTS)
    with LAUNCH_LOCK:
        embedding_bag_backward.launches += 1
    return out


def long_rows(row_ptr: torch.Tensor, n_slots: int) -> torch.Tensor:
    """The rows of the backward's CSR with more than ``LONG_SLOTS`` slots,
    longest first (ties by row), then -1 up to a fixed length: the most
    such rows ``n_slots`` slots can make (int32).  Sized without reading
    the device, so the launch waits on nothing; the backward's long-row
    kernel owns these rows."""
    cap = n_slots // (LONG_SLOTS + 1)
    if cap == 0:
        return torch.empty(0, dtype=torch.int32, device=row_ptr.device)
    lengths = row_ptr[1:] - row_ptr[:-1]
    rows = torch.nonzero_static(lengths > LONG_SLOTS, size=cap, fill_value=-1).squeeze(1)
    key = torch.where(rows >= 0, lengths[rows.clamp(min=0)], -1)
    return rows[torch.sort(key, descending=True, stable=True).indices].to(torch.int32)


def slot_csr(ids: torch.Tensor, V: int):
    """The backward's CSR over the ``V`` table rows: ``(row_ptr, bag,
    (run_of, run_bag, run_len))``, int32.  Row r's entries are the bags of
    the slots whose id is r, in slot order (a stable sort of every slot by
    id, the ids outside ``[0, V)`` keyed V, past every row: ``bag`` has an
    entry for each slot, and ``row_ptr[V]`` of them are the rows').  A run
    is a longest stretch of entries of one row with one bag: ``run_of[e]``
    numbers entry e's run (runs in entry order), ``run_bag`` and
    ``run_len`` give each run's bag and length (0 past the last run).  Raw
    tensors, not a ``segment_spmm.ops.EdgeCSR``: the launch needs neither
    its checks nor its row plan, a numpy pass over all ``V`` rows.  No
    device-to-host sync."""
    H = ids.shape[1]
    flat = ids.reshape(-1)
    n = flat.numel()
    key = torch.where((flat >= 0) & (flat < V), flat, V)
    rows, order = torch.sort(key, stable=True)
    row_ptr = torch.searchsorted(
        rows, torch.arange(V + 1, dtype=rows.dtype, device=ids.device), out_int32=True)
    bag = torch.div(order, H, rounding_mode="floor").to(torch.int32)
    head = torch.ones(n, dtype=torch.bool, device=ids.device)
    head[1:] = (rows[1:] != rows[:-1]) | (bag[1:] != bag[:-1])
    run_of = torch.cumsum(head, 0, dtype=torch.int32) - 1
    starts = torch.nonzero_static(head, size=n, fill_value=n).squeeze(1)
    run_len = torch.diff(starts, append=starts.new_full((1,), n)).to(torch.int32)
    run_bag = bag[starts.clamp(max=max(n - 1, 0))] if n else bag
    return row_ptr, bag, (run_of, run_bag, run_len)


#: backward kernel launches since the last reset (CPU calls do not count)
embedding_bag_backward.launches = 0


@torch.library.custom_op("repro_torch::embedding_bag", mutates_args=())
def _bag_op(table: torch.Tensor, ids: torch.Tensor, mean: bool) -> torch.Tensor:
    """The kernel or the plain version on a DTensor's local tensors."""
    return _launch(table, ids, "mean" if mean else "sum")


@_bag_op.register_fake
def _(table, ids, mean):
    return table.new_empty((ids.shape[0], table.shape[1]))


@torch.library.custom_op("repro_torch::embedding_bag_backward", mutates_args=())
def _bag_backward_op(g_out: torch.Tensor, ids: torch.Tensor, V: int,
                     mean: bool) -> torch.Tensor:
    return _launch_backward(g_out, ids, V, "mean" if mean else "sum")


@_bag_backward_op.register_fake
def _(g_out, ids, V, mean):
    return g_out.new_empty((V, g_out.shape[1]))


@register_flop_formula(torch.ops.repro_torch.embedding_bag)
def _(table_shape, ids_shape, *args, **kwargs) -> int:
    return ids_shape[0] * ids_shape[1] * table_shape[1]


@register_flop_formula(torch.ops.repro_torch.embedding_bag_backward)
def _(g_shape, ids_shape, *args, **kwargs) -> int:
    return ids_shape[0] * ids_shape[1] * g_shape[1]


#: the table's rows are gathered by the ids
GATHERED_INPUTS["repro_torch::embedding_bag"] = (0,)


@sharding_rules
def _register_sharding() -> None:
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.embedding_bag.default)
    def _(table, ids, mean):
        return [([Replicate()], [Replicate(), Replicate(), None]),
                ([Shard(0)], [Replicate(), Shard(0), None]),
                ([Shard(1)], [Shard(1), Replicate(), None])]

    @register_sharding(torch.ops.repro_torch.embedding_bag_backward.default)
    def _(g_out, ids, V, mean):
        return [([Replicate()], [Replicate(), Replicate(), None, None]),
                ([Shard(1)], [Shard(1), Replicate(), None, None])]


