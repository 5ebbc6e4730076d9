"""Wrapper of the ``segment_spmm`` kernel, and the edge layouts it reads.

``pack_edges`` sorts edges by destination and pads each destination block's
edge list to a multiple of ``block_e``, so every edge block belongs to
exactly one output block.  Padding edges carry weight 0 and point at row 0
of their block.  The arrays are bitwise those of the JAX package's packer;
this one computes them with one stable argsort, one ``np.bincount`` over
destination blocks and offset arithmetic, instead of a scan of the whole
edge list per block (quadratic at a million vertices).

The padded blocks served the TPU kernel's sequential grid.  The CUDA
kernels (``segment_spmm`` here, ``vm_step``) read the destination-sorted
CSR (:class:`EdgeCSR`) instead: the packing's real slots, in packed order,
or the same stable destination sort done on the device
(:func:`csr_from_edges`).  Each destination row is owned by one group of
lanes and summed in CSR order — no atomics, bitwise repeatable.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Union

import numpy as np
import torch

from repro_torch.kernels import LAUNCH_LOCK
from repro_torch.kernels.segment_spmm.ref import segment_spmm_csr_reference


@dataclass
class PackedEdges:
    src: np.ndarray          # (E_pad,)
    dst_local: np.ndarray    # (E_pad,)
    meta: np.ndarray         # (EB, 2) [dst_block_id, is_first]
    pad_mask: np.ndarray     # (E_pad,) True on real edges
    order: np.ndarray        # (E,) stable argsort of edge_dst: raw -> packed order
    n_blocks_out: int
    block_n: int
    block_e: int


def pack_edges(edge_src: np.ndarray, edge_dst: np.ndarray, n: int,
               block_n: int = 128, block_e: int = 256) -> PackedEdges:
    edge_src = np.asarray(edge_src)
    edge_dst = np.asarray(edge_dst)
    order = np.argsort(edge_dst, kind="stable")
    src_s, dst_s = edge_src[order], edge_dst[order]
    n_blocks_out = (n + block_n - 1) // block_n
    blk = (dst_s // block_n).astype(np.int64)

    cnt = np.bincount(blk, minlength=n_blocks_out)
    n_eb = np.maximum(1, (cnt + block_e - 1) // block_e)   # edge blocks per dst block
    first_sorted = np.cumsum(cnt) - cnt                     # block start, sorted order
    first_packed = (np.cumsum(n_eb) - n_eb) * block_e       # block start, packed order
    pos = first_packed[blk] + (np.arange(blk.size) - first_sorted[blk])
    E_pad = int(n_eb.sum()) * block_e

    src = np.zeros(E_pad, np.int32)
    dst_local = np.zeros(E_pad, np.int32)
    pad_mask = np.zeros(E_pad, bool)
    src[pos] = src_s
    dst_local[pos] = dst_s - blk * block_n
    pad_mask[pos] = True
    meta_blk = np.repeat(np.arange(n_blocks_out), n_eb)
    is_first = np.zeros(meta_blk.size, np.int64)
    is_first[np.cumsum(n_eb) - n_eb] = 1
    return PackedEdges(
        src=src,
        dst_local=dst_local,
        meta=np.stack([meta_blk, is_first], axis=1).astype(np.int32),
        pad_mask=pad_mask,
        order=order,
        n_blocks_out=n_blocks_out,
        block_n=block_n,
        block_e=block_e,
    )


def pack_weights(packed: PackedEdges, edge_w) -> np.ndarray:
    """Reorder raw per-edge weights into packed order (0 on padding).

    ``edge_w`` must align with the raw edge list the packing was built from;
    the dst-sort order recorded at pack time is applied directly.
    """
    w_sorted = np.asarray(edge_w)[packed.order]
    out = np.zeros(packed.src.shape[0], w_sorted.dtype)
    out[packed.pad_mask] = w_sorted
    return out


def packed_dst(packed: PackedEdges) -> np.ndarray:
    """(E_pad,) global destination per packed slot; padding slots alias the
    first row of their block (use ``packed.pad_mask`` to find them)."""
    return (np.repeat(packed.meta[:, 0], packed.block_e).astype(np.int64)
            * packed.block_n + packed.dst_local)


Array = Union[np.ndarray, torch.Tensor]

#: rows with more edges than this go to the ``vm_step`` kernel's long-row
#: path: one block per (row, 32-column block) gathers their messages in
#: parallel
LONG_ROW_EDGES = 256
#: every other row goes to a warp's run: at most RUN_ROWS consecutive rows,
#: cut where the count of edges before a row crosses a multiple of
#: RUN_EDGES, so no warp walks much more than RUN_EDGES + LONG_ROW_EDGES
#: edges (a skewed graph's early rows would otherwise fall to a few warps)
RUN_ROWS = 32
RUN_EDGES = 256


@dataclass(frozen=True)
class RowPlan:
    """How the ``vm_step`` kernel splits a CSR's rows.  ``runs`` (int32,
    ascending from 0 to n) cuts the rows into runs, each walked by one warp
    as one edge stream; a run that is one long row (more than
    ``LONG_ROW_EDGES`` edges) starts at ``~row`` instead of ``row``, and the
    warps skip it.  ``long_rows`` (int32, longest first, so the longest
    start first) lists those rows, each summed by a block per (row, column
    block).  So every row is summed by exactly one path."""

    runs: Array
    long_rows: Array

    def to(self, device) -> "RowPlan":
        """The plan as int32 tensors on ``device``."""
        return RowPlan(*(torch.as_tensor(a, device=device).to(torch.int32)
                         for a in (self.runs, self.long_rows)))


def row_plan(row_ptr: np.ndarray) -> RowPlan:
    """The :class:`RowPlan` of a CSR's offsets (numpy in, numpy out): a run
    starts at every ``RUN_ROWS``-th row, at every row whose first edge lies
    in another ``RUN_EDGES`` bucket than its predecessor's, and at each long
    row and the row after it, so a long row is a run of its own."""
    rp = np.asarray(row_ptr, np.int64)
    starts, deg = rp[:-1], np.diff(rp)
    long_ids = np.nonzero(deg > LONG_ROW_EDGES)[0]
    cut = np.arange(starts.shape[0]) % RUN_ROWS == 0
    cut[1:] |= starts[1:] // RUN_EDGES != starts[:-1] // RUN_EDGES
    cut[long_ids] = True
    cut[long_ids[long_ids + 1 < cut.shape[0]] + 1] = True
    runs = np.append(np.nonzero(cut)[0], starts.shape[0])
    runs[np.searchsorted(runs, long_ids)] = ~long_ids     # the warps skip these
    return RowPlan(runs.astype(np.int32),
                   long_ids[np.argsort(-deg[long_ids], kind="stable")].astype(np.int32))


@dataclass(frozen=True)
class EdgeCSR:
    """Destination-sorted CSR of an edge list: numpy arrays when derived
    from a packing, tensors when built on the device.  Within a row, edges
    keep their order in the edge list.

    Checked once, when made: ``row_ptr`` is nondecreasing from ``>= 0`` to
    ``len(src)``, source ids are ``>= 0``; ``src_bound`` is one past the
    largest source id, and ``plan`` the :class:`RowPlan` of ``row_ptr``, on
    its device.  So the kernels that read it need not check or plan it
    again (a check on the device costs a synchronisation per launch), and
    no plan can be paired with another CSR."""

    row_ptr: Array   # (n+1,) int32 offsets per destination row
    src: Array       # (E,) int32 source id per CSR slot
    order: Array     # (E,) int64 edge-list index per CSR slot
    src_bound: int = field(init=False)
    plan: RowPlan = field(init=False)

    def __post_init__(self):
        E = self.src.shape[0]
        if self.row_ptr.shape[0] < 1:
            raise ValueError("EdgeCSR: row_ptr needs n_rows + 1 >= 1 entries")
        src_range = [self.src.min(), self.src.max()] if E else []
        on_device = isinstance(self.row_ptr, torch.Tensor)
        if on_device:
            # one synchronisation: row_ptr and the source range to the host
            n1 = self.row_ptr.shape[0]
            host = torch.cat([self.row_ptr.long()] + [v.long()[None] for v in src_range]
                             ).cpu().numpy()
            rp, src_range = host[:n1], host[n1:]
        else:
            rp = np.asarray(self.row_ptr, np.int64)
        smin, smax = (int(v) for v in src_range) if E else (0, -1)
        if rp[0] < 0 or rp[-1] != E or np.any(np.diff(rp) < 0) or smin < 0:
            raise ValueError("EdgeCSR: row_ptr must lie in [0, len(src)], be "
                             "nondecreasing and end at len(src), and source ids "
                             "must be >= 0")
        plan = row_plan(rp)
        object.__setattr__(self, "src_bound", smax + 1)
        object.__setattr__(self, "plan", plan.to(self.row_ptr.device) if on_device else plan)

    def to(self, device) -> "EdgeCSR":
        """The CSR as tensors on ``device`` (int32 offsets and sources,
        int64 order), with its checks and plan carried over, not redone."""
        moved = copy.copy(self)
        for name, dtype in (("row_ptr", torch.int32), ("src", torch.int32),
                            ("order", torch.int64)):
            object.__setattr__(moved, name, torch.as_tensor(
                getattr(self, name), device=device).to(dtype))
        object.__setattr__(moved, "plan", self.plan.to(device))
        return moved


def csr_from_packing(packed: PackedEdges, dst_global: np.ndarray,
                     n: int) -> EdgeCSR:
    """Strip the block padding off a packing: its real slots, in packed
    order, are the edges in stable destination order."""
    dst = dst_global[packed.pad_mask]
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n), out=row_ptr[1:])
    return EdgeCSR(row_ptr=row_ptr.astype(np.int32),
                   src=packed.src[packed.pad_mask],
                   order=packed.order.astype(np.int64))


def csr_from_shard(sp, s: int, exchange: str = "sliced") -> EdgeCSR:
    """Shard ``s`` of a ``ShardedVMPacking`` as a CSR over its
    ``n_local_pad`` local rows (local row = the slot's destination block in
    ``meta`` times ``block_n`` plus ``dst_local``): its real slots
    (``slot_raw >= 0``), in packed order, which within each destination is
    ascending source order, as in the global CSR.  Sources index the
    shard's ``[local rows | exchanged rows]`` buffer through ``src_map``
    (``exchange="psum"``) or ``src_map_sliced`` (``"sliced"``); ``order``
    holds each entry's slot in the shard, so per-slot values scatter back."""
    if exchange not in ("sliced", "psum"):
        raise ValueError(f"unknown halo exchange {exchange!r}")
    slots = np.nonzero(sp.slot_raw[s] >= 0)[0]
    rows = (sp.meta[s, slots // sp.block_e, 0].astype(np.int64) * sp.block_n
            + sp.dst_local[s, slots])
    if np.any(np.diff(rows) < 0):
        raise ValueError(f"csr_from_shard: shard {s}'s slots are not in "
                         "destination order")
    row_ptr = np.zeros(sp.n_local_pad + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=sp.n_local_pad), out=row_ptr[1:])
    src_map = sp.src_map_sliced if exchange == "sliced" else sp.src_map
    return EdgeCSR(row_ptr=row_ptr.astype(np.int32), src=src_map[s, slots],
                   order=slots.astype(np.int64))


def csr_from_edges(edge_src: torch.Tensor, edge_dst: torch.Tensor,
                   n: int) -> EdgeCSR:
    """The same stable destination sort as :func:`pack_edges`, on the edge
    tensors' device; gives tensors bitwise equal to
    ``csr_from_packing(pack_edges(...))``."""
    if edge_src.shape[0] >= 2**31:
        raise ValueError("csr_from_edges: the CSR's int32 offsets take "
                         "fewer than 2**31 edges")
    order = torch.argsort(edge_dst, stable=True)
    row_ptr = torch.zeros(n + 1, dtype=torch.int64, device=edge_dst.device)
    torch.cumsum(torch.bincount(edge_dst.long(), minlength=n), 0,
                 out=row_ptr[1:])
    return EdgeCSR(row_ptr=row_ptr.to(torch.int32),
                   src=edge_src[order].to(torch.int32), order=order)


def _check(x, csr, w) -> None:
    for name, t, dt, ndim in (("x", x, torch.float32, 2),
                              ("row_ptr", csr.row_ptr, torch.int32, 1),
                              ("src", csr.src, torch.int32, 1),
                              ("w", w, torch.float32, 1)):
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"segment_spmm: {name} must be a tensor")
        if t.device != x.device:
            raise ValueError(f"segment_spmm: {name} is on {t.device}, x on {x.device}")
        if t.dtype != dt or t.dim() != ndim:
            raise ValueError(f"segment_spmm: {name} must be {ndim}-D {dt}, "
                             f"got {t.dim()}-D {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"segment_spmm: {name} must be contiguous")
    if csr.src.shape != w.shape:
        raise ValueError("segment_spmm: src and w must have one entry per edge")
    if csr.src_bound > x.shape[0]:
        raise ValueError(f"segment_spmm: source id {csr.src_bound - 1} "
                         f"indexes past x's {x.shape[0]} rows")


def vector_width(x: torch.Tensor) -> int:
    """Floats per load of ``x``'s rows in the kernel: 4 (16-byte ``float4``
    loads) when every row starts on a 16-byte boundary — ``F`` a multiple
    of 4 and ``x`` itself 16-byte aligned — else 1 (scalar loads)."""
    return 4 if x.shape[1] % 4 == 0 and x.data_ptr() % 16 == 0 else 1


def segment_spmm_csr(x: torch.Tensor, csr: EdgeCSR,
                     w: torch.Tensor) -> torch.Tensor:
    """``out[v] = sum over CSR row v of w_e * x[src_e]``, ``(n_rows, F)``.

    ``csr`` is a destination-sorted CSR of tensors (checked when it was
    made, so a launch does not synchronise) and ``w`` the weight of each
    CSR slot.  CUDA tensors go to the hand-written kernel
    (``csrc/segment_spmm.cu``), CPU tensors to the plain version.
    """
    _check(x, csr, w)
    if x.device.type == "cpu":
        return segment_spmm_csr_reference(x, csr.row_ptr, csr.src, w)
    if x.device.type != "cuda":
        raise ValueError(f"segment_spmm: no kernel for device {x.device}")
    from repro_torch.kernels.segment_spmm.kernel import segment_spmm_cuda

    out = segment_spmm_cuda(x, csr.row_ptr, csr.src, w, vector_width(x))
    with LAUNCH_LOCK:
        segment_spmm_csr.launches += 1
    return out


#: kernel launches since the last reset (CPU calls do not count)
segment_spmm_csr.launches = 0


def segment_spmm(x: torch.Tensor, packed: PackedEdges, edge_w: torch.Tensor,
                 n_out: int) -> torch.Tensor:
    """``out[dst] += w_e * x[src]`` over a packing; returns ``(n_out, F)``.

    ``edge_w`` is ``(E_pad,)``, aligned with the packed order
    (:func:`pack_weights`); padding slots are dropped, not added as 0.
    """
    dst = packed_dst(packed)
    if dst.size and dst[packed.pad_mask].max(initial=0) >= n_out:
        raise ValueError("segment_spmm: an edge points past n_out")
    on_x = csr_from_packing(packed, dst, n_out).to(x.device)
    real = torch.from_numpy(packed.pad_mask).to(edge_w.device)
    return segment_spmm_csr(x, on_x, edge_w[real].contiguous())
