"""Wrapper of the ``vm_step`` kernel, and its host-side packings.

``pack_vm_inputs`` keeps the JAX package's block-padded layout (bitwise);
the CUDA kernel reads the dst-sorted CSR (:class:`VMCSR`) derived from that
packing's stable destination sort, so each destination row is owned by one
warp and summed in a fixed order — no atomics, bitwise repeatable.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.segment_spmm.ops import PackedEdges, pack_edges
from repro_torch.kernels.vm_step.ref import vm_step_reference

#: largest trie the kernel takes: two columns per lane of one warp
MAX_TRIE_NODES = 64
#: dynamic shared memory one block may use on Hopper (bytes); T lives there
MAX_T_BYTES = 232_448


def pack_vm_inputs(edge_src, edge_dst, labels, cnt, n: int,
                   block_n: int = 128, block_e: int = 256):
    """Pack edges (sorted by dst) and per-edge label / 1/cnt channels."""
    packed = pack_edges(edge_src, edge_dst, n, block_n, block_e)
    order = packed.order  # pack_edges already sorted by dst; reuse its order
    dst_lab_sorted = np.asarray(labels)[np.asarray(edge_dst)[order]]
    src_sorted = np.asarray(edge_src)[order]
    inv = 1.0 / np.maximum(
        np.asarray(cnt)[src_sorted, dst_lab_sorted], 1.0)
    E_pad = packed.src.shape[0]
    dst_label = np.zeros(E_pad, np.int32)
    inv_cnt = np.zeros(E_pad, np.float32)
    dst_label[packed.pad_mask] = dst_lab_sorted
    inv_cnt[packed.pad_mask] = inv
    return packed, dst_label, inv_cnt


@dataclass
class VMCSR:
    """Destination-sorted CSR of a graph's directed edges (numpy).  Within a
    row, edges keep their order in the source edge list."""

    row_ptr: np.ndarray   # (n+1,) int32 offsets per destination row
    src: np.ndarray       # (E,) int32 source id per CSR slot
    order: np.ndarray     # (E,) int64 edge-list index per CSR slot


def csr_from_packing(packed: PackedEdges, dst_global: np.ndarray,
                     n: int) -> VMCSR:
    """Strip the block padding off a ``pack_vm_inputs`` packing: its real
    slots, in packed order, are the edges in stable destination order."""
    dst = dst_global[packed.pad_mask]
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n), out=row_ptr[1:])
    return VMCSR(row_ptr=row_ptr.astype(np.int32),
                 src=packed.src[packed.pad_mask],
                 order=packed.order.astype(np.int64))


def _check(alpha, T, row_ptr, src, w, row_label) -> None:
    dev = alpha.device
    named = dict(alpha=alpha, T=T, row_ptr=row_ptr, src=src, w=w,
                 row_label=row_label)
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"vm_step: {name} is on {t.device}, alpha on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"vm_step: {name} must be contiguous")
    for name, t, dt, ndim in (("alpha", alpha, torch.float32, 2),
                              ("T", T, torch.float32, 3),
                              ("row_ptr", row_ptr, torch.int32, 1),
                              ("src", src, torch.int32, 1),
                              ("w", w, torch.float32, 1),
                              ("row_label", row_label, torch.int32, 1)):
        if t.dtype != dt or t.dim() != ndim:
            raise ValueError(f"vm_step: {name} must be {ndim}-D {dt}, "
                             f"got {t.dim()}-D {t.dtype}")
    n, N = alpha.shape
    if T.shape[1:] != (N, N):
        raise ValueError(f"vm_step: T is {tuple(T.shape)}, alpha has N={N}")
    if row_ptr.shape[0] != n + 1 or row_label.shape[0] != n:
        raise ValueError("vm_step: row_ptr must be (n+1,) and row_label (n,)")
    if src.shape != w.shape:
        raise ValueError("vm_step: src and w must have one entry per edge")


def vm_step(alpha: torch.Tensor, T: torch.Tensor, row_ptr: torch.Tensor,
            src: torch.Tensor, w: torch.Tensor,
            row_label: torch.Tensor) -> torch.Tensor:
    """``out[v] = sum over CSR row v of (alpha[src_e] @ T[row_label[v]]) * w_e``.

    ``row_ptr``/``src`` are a destination-sorted CSR (:class:`VMCSR`),
    ``w`` the per-edge weight (``inv_cnt`` times the local-edge mask) and
    ``row_label`` each destination's vertex label.  CUDA tensors go to the
    hand-written kernel (``csrc/vm_step.cu``); CPU tensors to the plain
    version.  Labels must lie in ``[0, L)``.
    """
    _check(alpha, T, row_ptr, src, w, row_label)
    n, N = alpha.shape
    if alpha.device.type == "cpu":
        dst = torch.repeat_interleave(
            torch.arange(n), (row_ptr[1:] - row_ptr[:-1]).long())
        return vm_step_reference(alpha, T, src.long(), dst, w,
                                 row_label.long()[dst], n)
    if alpha.device.type != "cuda":
        raise ValueError(f"vm_step: no kernel for device {alpha.device}")
    if N > MAX_TRIE_NODES:
        raise ValueError(f"vm_step kernel takes at most {MAX_TRIE_NODES} "
                         f"trie nodes, got N={N}")
    if T.numel() * 4 > MAX_T_BYTES:
        raise ValueError(f"vm_step kernel: T is {T.numel() * 4} bytes, more "
                         f"than the {MAX_T_BYTES} bytes of shared memory")
    from repro_torch.kernels.vm_step.kernel import vm_step_cuda

    out = vm_step_cuda(alpha, T, row_ptr, src, w, row_label)
    vm_step.launches += 1
    return out


#: kernel launches since the last reset (CPU calls do not count)
vm_step.launches = 0
