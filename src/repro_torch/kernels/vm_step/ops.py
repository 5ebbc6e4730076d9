"""Wrapper of the ``vm_step`` kernel, and its host-side packings.

``pack_vm_inputs`` keeps the JAX package's block-padded layout (bitwise);
the CUDA kernel reads the dst-sorted CSR
(:class:`repro_torch.kernels.segment_spmm.ops.EdgeCSR`) derived from that
packing's stable destination sort, so each destination row's output is
written by one warp, summed in a fixed order — no atomics, bitwise
repeatable.
"""
from __future__ import annotations

import numpy as np
import torch

# the dst-sorted CSR serves both CUDA kernels; it lives with the packer
# (re-exported here, its import path before segment_spmm was ported)
from repro_torch.kernels.segment_spmm.ops import (  # noqa: F401
    csr_from_packing, pack_edges)
from repro_torch.kernels.vm_step.ref import vm_step_reference


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


def _check(alpha, par, val, row_ptr, src, w, row_label) -> None:
    dev = alpha.device
    named = dict(alpha=alpha, par=par, val=val, row_ptr=row_ptr, src=src, w=w,
                 row_label=row_label)
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"vm_step: {name} is on {t.device}, alpha on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"vm_step: {name} must be contiguous")
    for name, t, dt, ndim in (("alpha", alpha, torch.float32, 2),
                              ("par", par, torch.int32, 2),
                              ("val", val, torch.float32, 2),
                              ("row_ptr", row_ptr, torch.int32, 1),
                              ("src", src, torch.int32, 1),
                              ("w", w, torch.float32, 1),
                              ("row_label", row_label, torch.int32, 1)):
        if t.dtype != dt or t.dim() != ndim:
            raise ValueError(f"vm_step: {name} must be {ndim}-D {dt}, "
                             f"got {t.dim()}-D {t.dtype}")
    n, N = alpha.shape
    if par.shape != val.shape or par.shape[1] != N:
        raise ValueError(f"vm_step: par {tuple(par.shape)} and val "
                         f"{tuple(val.shape)} must be (L, N), alpha has N={N}")
    if row_ptr.shape[0] != n + 1 or row_label.shape[0] != n:
        raise ValueError("vm_step: row_ptr must be (n+1,) and row_label (n,)")
    if src.shape != w.shape:
        raise ValueError("vm_step: src and w must have one entry per edge")


def vm_step(alpha: torch.Tensor, par: torch.Tensor, val: torch.Tensor,
            row_ptr: torch.Tensor, src: torch.Tensor, w: torch.Tensor,
            row_label: torch.Tensor) -> torch.Tensor:
    """``out[v] = sum over CSR row v of (alpha[src_e] @ T[row_label[v]]) * w_e``.

    ``par``/``val`` are the trie transition ``T`` in its column form
    (:func:`repro_torch.kernels.vm_step.ref.transition_columns`),
    ``row_ptr``/``src`` a destination-sorted CSR (``EdgeCSR``), ``w`` the
    per-edge weight (``inv_cnt`` times the local-edge mask) and
    ``row_label`` each destination's vertex label.  CUDA tensors go to the
    hand-written kernel (``csrc/vm_step.cu``); CPU tensors to the plain
    version.  Labels must lie in ``[0, L)`` and ``par`` in ``[0, N)``.
    """
    _check(alpha, par, val, row_ptr, src, w, row_label)
    n = alpha.shape[0]
    if alpha.device.type == "cpu":
        dst = torch.repeat_interleave(
            torch.arange(n), (row_ptr[1:] - row_ptr[:-1]).long())
        return vm_step_reference(alpha, par, val, src, dst, w,
                                 row_label[dst], n)
    if alpha.device.type != "cuda":
        raise ValueError(f"vm_step: no kernel for device {alpha.device}")
    from repro_torch.kernels.vm_step.kernel import vm_step_cuda

    out = vm_step_cuda(alpha, par, val, row_ptr, src, w, row_label)
    vm_step.launches += 1
    return out


#: kernel launches since the last reset (CPU calls do not count)
vm_step.launches = 0
