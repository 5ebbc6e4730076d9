"""Plain PyTorch version of the edge-weighted gather-scatter SpMM, and the
port's plain scatter-adds.

``out[dst] += w_e * x[src]`` — the GNN message-passing primitive.  Edges go
through in chunks so the (E, F) message tensor never exists whole (61.9M
edges x 100 features would be 24.7 GB).  ``segment_spmm_csr_reference`` is
the CPU path of ``ops.segment_spmm_csr`` and the kernel's yardstick on the
card.

Every plain scatter-add of the port adds each output row's terms in edge
order, starting from 0, on every device.  On the CPU ``index_add_`` does
that; on the card it adds with atomics in no fixed order, so there the sums
go through a stable sort of the index and one sequential sum per segment
(``scatter_add_sorted``, ``segment_spmm_sorted``), which give the CPU's
result bit for bit.
"""
from __future__ import annotations

import math

import torch

#: edges per chunk of the message tensor
CHUNK = 1 << 22


def segment_sum(vals: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Sums of the rows of ``vals`` grouped in contiguous runs of
    ``lengths``; each run is summed in row order starting from 0.

    The values go in as 2-D so ``torch.segment_reduce`` takes its generic
    path, which walks each segment sequentially on the CPU and on the card
    (deterministic, and the same order as a sequential scatter-add of the
    rows)."""
    flat = vals.dim() == 1
    v = vals[:, None] if flat else vals
    if v.shape[0] == 0:
        out = v.new_zeros((lengths.shape[0], v.shape[1]))
    else:
        out = torch.segment_reduce(v, "sum", lengths=lengths, axis=0)
    return out[:, 0] if flat else out


def _dst_order(index: torch.Tensor):
    """A stable sort of ``index`` (int64): ``(sorted index, order)``, with
    order None when the index is already nondecreasing."""
    if index.shape[0] < 2 or bool((index[1:] >= index[:-1]).all()):
        return index, None
    order = torch.argsort(index, stable=True)
    return index[order], order


def scatter_add_sorted(values: torch.Tensor, index: torch.Tensor, n: int) -> torch.Tensor:
    """``out[i] = sum of values[e] over index[e] == i`` for ``values`` (E,
    ...), ``out`` (n, ...): each row's terms added in edge order from 0, as
    ``index_add_`` adds them on the CPU, on any device."""
    index, order = _dst_order(index.long())
    if order is not None:
        values = values[order]
    lengths = torch.bincount(index, minlength=n)
    tail = tuple(values.shape[1:])
    flat = values.reshape(values.shape[0], math.prod(tail))
    return segment_sum(flat, lengths).reshape((n,) + tail)


def scatter_add(values: torch.Tensor, index: torch.Tensor, n: int) -> torch.Tensor:
    """``scatter_add_sorted``'s result: ``index_add_`` on the CPU, the
    sorted segment sums elsewhere."""
    if values.device.type != "cpu":
        return scatter_add_sorted(values, index, n)
    out = values.new_zeros((n,) + tuple(values.shape[1:]))
    return out.index_add_(0, index.long(), values)


def segment_spmm_sorted(x: torch.Tensor, edge_src: torch.Tensor, edge_dst: torch.Tensor,
                        edge_w: torch.Tensor, n_out: int) -> torch.Tensor:
    """``segment_spmm_reference``'s sums in its CPU order on any device.

    The edges are sorted stably by destination (not when they already
    are) and taken CHUNK at a time; a chunk covers a run of rows, and its
    first row may have begun in the chunk before.  That row's running value
    goes first in its segment, so every row is folded from 0 one message at
    a time, in edge order, across chunk boundaries: ``index_add_``'s
    rounding on the CPU.  Messages are made in one (CHUNK + 1, F) buffer."""
    E, F = edge_src.shape[0], x.shape[1]
    out = torch.zeros((n_out, F), dtype=x.dtype, device=x.device)
    dst, order = _dst_order(edge_dst.long())
    buf = x.new_empty((min(CHUNK, E) + 1, F))
    for lo in range(0, E, CHUNK):
        hi = min(lo + CHUNK, E)
        take = slice(lo, hi) if order is None else order[lo:hi]
        d = dst[lo:hi]
        r0, r1 = int(d[0]), int(d[-1]) + 1
        msgs = buf[:hi - lo + 1]
        msgs[0] = out[r0]                            # the running row
        torch.index_select(x, 0, edge_src[take].long(), out=msgs[1:])
        msgs[1:].mul_(edge_w[take, None].to(x.dtype))
        lengths = torch.bincount(d - r0, minlength=r1 - r0)
        lengths[0] += 1
        out[r0:r1] = segment_sum(msgs, lengths)
    return out


def segment_spmm_reference(
    x: torch.Tensor,          # (n, F) node features
    edge_src: torch.Tensor,   # (E,) int
    edge_dst: torch.Tensor,   # (E,) int
    edge_w: torch.Tensor,     # (E,) float
    n_out: int,
) -> torch.Tensor:
    """``out[dst] += w_e * x[src]``: ``index_add_`` chunk by chunk on the
    CPU (edge order), ``segment_spmm_sorted`` elsewhere."""
    if x.device.type != "cpu":
        return segment_spmm_sorted(x, edge_src, edge_dst, edge_w, n_out)
    out = torch.zeros((n_out, x.shape[1]), dtype=x.dtype, device=x.device)
    for lo in range(0, edge_src.shape[0], CHUNK):
        s, d = edge_src[lo:lo + CHUNK].long(), edge_dst[lo:lo + CHUNK].long()
        msgs = x[s] * edge_w[lo:lo + CHUNK, None].to(x.dtype)
        out.index_add_(0, d, msgs)
    return out


def segment_spmm_csr_reference(x: torch.Tensor, row_ptr: torch.Tensor,
                               src: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same function over a destination-sorted CSR: ``(n_rows, F)``."""
    n_rows = row_ptr.shape[0] - 1
    dst = torch.repeat_interleave(
        torch.arange(n_rows, device=x.device), (row_ptr[1:] - row_ptr[:-1]).long())
    return segment_spmm_reference(x, src, dst, w, n_rows)
