"""Wrapper of the ``vm_step`` kernel, and its host-side packings.

``pack_vm_inputs`` keeps the JAX package's block-padded layout (bitwise);
the CUDA kernel reads the dst-sorted CSR
(:class:`repro_torch.kernels.segment_spmm.ops.EdgeCSR`) derived from that
packing's stable destination sort, so each destination row's output is
written by one lane per column, summed in a fixed order — no atomics,
bitwise repeatable.  How the kernel splits the rows among its warps and
blocks is the CSR's ``RowPlan``, made once with the CSR, so a launch
needs no synchronisation.

Fake tensors and DTensors (``kernels.traced``) go through the
custom op ``repro_torch::vm_step``: its fake route returns an empty output,
its FLOP formula counts a multiply-add per CSR slot and column, and its
sharding rule takes every input replicated (the CSR's rows index the whole
of ``alpha``).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import GATHERED_INPUTS, LAUNCH_LOCK, KernelError, sharding_rules, traced

# the dst-sorted CSR serves both CUDA kernels; it lives with the packer
# (re-exported here, its import path before segment_spmm was ported)
from repro_torch.kernels.segment_spmm.ops import (  # noqa: F401
    EdgeCSR, RowPlan, csr_from_packing, pack_edges)
from repro_torch.kernels.vm_step.ref import vm_step_reference
from repro_torch.obs.registry import default_registry

#: CUDA launches of the kernel in this process (the plain version's calls
#: on the CPU do not count)
_LAUNCHES = default_registry().counter("vm_step_launches_total")


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


def _check(alpha, par, val, csr, w, row_label) -> None:
    dev = alpha.device
    named = [("alpha", alpha, torch.float32, 2),
             ("par", par, torch.int32, 2),
             ("val", val, torch.float32, 2),
             ("row_ptr", csr.row_ptr, torch.int32, 1),
             ("src", csr.src, torch.int32, 1),
             ("w", w, torch.float32, 1),
             ("row_label", row_label, torch.int32, 1)]
    if csr.plan is not None:      # a CSR of fake tensors has no plan
        named += [("runs", csr.plan.runs, torch.int32, 1),
                  ("long_rows", csr.plan.long_rows, torch.int32, 1)]
    for name, t, dt, ndim in named:
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"vm_step: {name} must be a tensor")
        if t.device != dev:
            raise ValueError(f"vm_step: {name} is on {t.device}, alpha on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"vm_step: {name} must be contiguous")
        if t.dtype != dt or t.dim() != ndim:
            raise ValueError(f"vm_step: {name} must be {ndim}-D {dt}, "
                             f"got {t.dim()}-D {t.dtype}")
    n_in, N = alpha.shape
    n_out = csr.row_ptr.shape[0] - 1
    if par.shape != val.shape or par.shape[1] != N:
        raise ValueError(f"vm_step: par {tuple(par.shape)} and val "
                         f"{tuple(val.shape)} must be (L, N), alpha has N={N}")
    if row_label.shape[0] != n_out:
        raise ValueError(f"vm_step: row_label must have one entry per output "
                         f"row ({n_out}), got {row_label.shape[0]}")
    if csr.src.shape != w.shape:
        raise ValueError("vm_step: src and w must have one entry per edge")
    if csr.src_bound is not None and csr.src_bound > n_in:
        raise ValueError(f"vm_step: source id {csr.src_bound - 1} indexes past "
                         f"alpha's {n_in} rows")


def vm_step(alpha: torch.Tensor, par: torch.Tensor, val: torch.Tensor,
            csr: EdgeCSR, w: torch.Tensor, row_label: torch.Tensor) -> torch.Tensor:
    """``out[v] = sum over CSR row v of (alpha[src_e] @ T[row_label[v]]) * w_e``.

    The output has one row per CSR row (``csr.row_ptr.shape[0] - 1``);
    ``alpha`` may have more rows than that (a shard's own rows followed by
    the halo rows exchanged from other shards), and every source must lie
    below ``alpha.shape[0]``.
    ``par``/``val`` are the trie transition ``T`` in its column form
    (:func:`repro_torch.kernels.vm_step.ref.transition_columns`), ``csr``
    a destination-sorted CSR of tensors (checked and planned when it was
    made, so a launch does not synchronise), ``w`` the per-edge weight
    (``inv_cnt`` times the local-edge mask) and ``row_label`` each
    destination's vertex label.  CUDA tensors go to the hand-written kernel
    (``csrc/vm_step.cu``), which splits the rows by ``csr.plan``; CPU
    tensors to the plain version.  Labels must lie in ``[0, L)`` and
    ``par`` in ``[0, N)``.
    """
    _check(alpha, par, val, csr, w, row_label)
    if traced(alpha, csr.row_ptr):
        plan = csr.plan
        if plan is None:            # a fake CSR's: the fake route reads no plan
            plan = RowPlan(*(csr.row_ptr.new_empty(0) for _ in range(2)))
        return _vm_step_op(alpha, par, val, csr.row_ptr, csr.src, w, row_label,
                           plan.runs, plan.long_rows)
    return _launch(alpha, par, val, csr.row_ptr, csr.src, w, row_label,
                   csr.plan.runs, csr.plan.long_rows)


def _launch(alpha, par, val, row_ptr, src, w, row_label, runs, long_rows):
    n_out = row_ptr.shape[0] - 1
    if alpha.device.type == "cpu":
        dst = torch.repeat_interleave(
            torch.arange(n_out), (row_ptr[1:] - row_ptr[:-1]).long())
        return vm_step_reference(alpha, par, val, src, dst, w,
                                 row_label[dst], n_out)
    if alpha.device.type != "cuda":
        raise ValueError(f"vm_step: no kernel for device {alpha.device}")
    if alpha.numel() >= 2**31 - 1:
        raise KernelError("vm_step: the kernel indexes alpha with int32 offsets")
    if runs.shape[0] < 1:
        raise KernelError("vm_step: the CSR has no row plan (a plan has at least one run)")
    from repro_torch.kernels.vm_step.kernel import vm_step_cuda

    out = vm_step_cuda(alpha, par, val, row_ptr, src, w, row_label, runs, long_rows)
    with LAUNCH_LOCK:
        _LAUNCHES.inc()
    return out


@torch.library.custom_op("repro_torch::vm_step", mutates_args=())
def _vm_step_op(alpha: torch.Tensor, par: torch.Tensor, val: torch.Tensor,
                row_ptr: torch.Tensor, src: torch.Tensor, w: torch.Tensor,
                row_label: torch.Tensor, runs: torch.Tensor,
                long_rows: torch.Tensor) -> torch.Tensor:
    """The kernel or the plain version on a DTensor's local tensors."""
    return _launch(alpha, par, val, row_ptr, src, w, row_label, runs, long_rows)


@_vm_step_op.register_fake
def _(alpha, par, val, row_ptr, src, w, row_label, runs, long_rows):
    return alpha.new_empty((row_ptr.shape[0] - 1, alpha.shape[1]))


@register_flop_formula(torch.ops.repro_torch.vm_step)
def _(alpha_shape, par_shape, val_shape, row_ptr_shape, src_shape, *args, **kwargs) -> int:
    return 2 * src_shape[0] * alpha_shape[1]


#: alpha's rows are gathered by the CSR's sources
GATHERED_INPUTS["repro_torch::vm_step"] = (0,)


@sharding_rules
def _register_sharding() -> None:
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.vm_step.default)
    def _(*args):
        return [([Replicate()], [Replicate()] * 9)]


