"""Block-padded destination-sorted edge packing (host-side numpy).

``pack_edges`` sorts edges by destination and pads each destination block's
edge list to a multiple of ``block_e``, so every edge block belongs to
exactly one output block.  Padding edges carry weight 0 and point at row 0
of their block.  The arrays are bitwise those of the JAX package's packer;
this one computes them with one stable argsort, one ``np.bincount`` over
destination blocks and offset arithmetic, instead of a scan of the whole
edge list per block (quadratic at a million vertices).

Only the packer is ported here: the ``segment_spmm`` kernel itself is not
on the TAPER path and waits for the model-stack slice.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


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
