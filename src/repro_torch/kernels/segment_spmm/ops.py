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
(:func:`csr_from_edges`).  Each destination row is owned by one warp and
summed in CSR order — no atomics, bitwise repeatable.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Union

import numpy as np
import torch

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


@dataclass(frozen=True)
class EdgeCSR:
    """Destination-sorted CSR of an edge list: numpy arrays when derived
    from a packing, tensors when built on the device.  Within a row, edges
    keep their order in the edge list.

    Checked once, when made: ``row_ptr`` lies in ``[0, len(src)]`` and ends
    at ``len(src)``, source ids are ``>= 0``; ``src_bound`` is one past the
    largest source id.  So the kernels that read it need not check it again
    (a check on the device costs a synchronisation per launch)."""

    row_ptr: Array   # (n+1,) int32 offsets per destination row
    src: Array       # (E,) int32 source id per CSR slot
    order: Array     # (E,) int64 edge-list index per CSR slot
    src_bound: int = field(init=False)

    def __post_init__(self):
        E = self.src.shape[0]
        if self.row_ptr.shape[0] < 1:
            raise ValueError("EdgeCSR: row_ptr needs n_rows + 1 >= 1 entries")
        stats = [self.row_ptr.min(), self.row_ptr.max(), self.row_ptr[-1]]
        if E:
            stats += [self.src.min(), self.src.max()]
        if isinstance(self.row_ptr, torch.Tensor):
            # one synchronisation for all five
            stats = torch.stack([torch.as_tensor(v, device=self.row_ptr.device)
                                 .long() for v in stats]).tolist()
        lo, hi, last, *src_range = (int(v) for v in stats)
        smin, smax = src_range or (0, -1)
        if lo < 0 or hi > E or last != E or smin < 0:
            raise ValueError("EdgeCSR: row_ptr must lie in [0, len(src)] and "
                             "end at len(src), and source ids must be >= 0")
        object.__setattr__(self, "src_bound", smax + 1)


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

    out = segment_spmm_cuda(x, csr.row_ptr, csr.src, w)
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
    csr = csr_from_packing(packed, dst, n_out)
    on_x = EdgeCSR(*(torch.as_tensor(a, device=x.device)
                     for a in (csr.row_ptr, csr.src, csr.order)))
    real = torch.from_numpy(packed.pad_mask).to(edge_w.device)
    return segment_spmm_csr(x, on_x, edge_w[real].contiguous())
