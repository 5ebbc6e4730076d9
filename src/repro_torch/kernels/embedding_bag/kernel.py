"""ctypes bindings of the hand-written CUDA ``embedding_bag`` kernels.

The forward (``kernels/csrc/embedding_bag.cu``) replaces the TPU kernel
``src/repro/kernels/embedding_bag/kernel.py::_bag_kernel``; the backward
(``kernels/csrc/embedding_bag_bwd.cu``, the table's dense gradient)
replaces none: the JAX package differentiates its ``jnp`` bag.  See each
source for its design.  The shared libraries are built from the checkout at
first use (``kernels/build.py``) and launched on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import KernelError


@functools.lru_cache(maxsize=None)
def _launcher():
    from repro_torch.kernels.build import load

    fn = load("embedding_bag").embedding_bag_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def embedding_bag_cuda(table: torch.Tensor, ids: torch.Tensor, mean: bool,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel; arguments are checked by ``ops.embedding_bag``.
    ``out``, when given, is a contiguous (B, d) float32 tensor on the
    table's device to write into (at any 4-byte alignment)."""
    V, d = table.shape
    B, H = ids.shape
    if out is None:
        out = torch.empty((B, d), dtype=table.dtype, device=table.device)
    elif (out.shape != (B, d) or out.dtype != table.dtype or out.device != table.device
          or not out.is_contiguous()):
        raise ValueError(f"embedding_bag: out must be a contiguous ({B}, {d}) "
                         f"{table.dtype} tensor on {table.device}")
    with torch.cuda.device(table.device):
        err = _launcher()(
            table.data_ptr(), ids.data_ptr(), out.data_ptr(), V, d, B, H,
            int(mean), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise KernelError(f"embedding_bag kernel launch failed: CUDA error {err}")
    return out


@functools.lru_cache(maxsize=None)
def _bwd_launcher():
    from repro_torch.kernels.build import load

    fn = load("embedding_bag_bwd").embedding_bag_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


#: ``parts`` of the backward: the long-row kernel alone, the rows kernel
#: alone (each leaves the other's rows unwritten), both
BWD_LONG, BWD_ROWS, BWD_ALL = 1, 2, 3


def embedding_bag_backward_cuda(g: torch.Tensor, row_ptr: torch.Tensor, bag: torch.Tensor,
                                runs, long_rows: torch.Tensor, long_slots: int,
                                parts: int = BWD_ALL) -> torch.Tensor:
    """Launch the backward kernels; the (V + 1) ``row_ptr``, ``bag``, the
    ``runs`` (``run_of``, ``run_bag``, ``run_len``) and ``long_rows`` (the
    rows with more than ``long_slots`` slots, longest first, maybe followed
    by -1) come from ``ops.embedding_bag_backward``.  Returns the dense
    (V, d) gradient; ``parts`` other than ``BWD_ALL`` launch one kernel
    alone, for timing."""
    V, d = row_ptr.shape[0] - 1, g.shape[1]
    out = torch.empty((V, d), dtype=torch.float32, device=g.device)
    vec = 4 if d % 4 == 0 and g.data_ptr() % 16 == 0 else 1
    run_of, run_bag, run_len = runs
    with torch.cuda.device(g.device):
        err = _bwd_launcher()(
            g.data_ptr(), row_ptr.data_ptr(), bag.data_ptr(), run_of.data_ptr(),
            run_bag.data_ptr(), run_len.data_ptr(), long_rows.data_ptr(), long_rows.shape[0],
            out.data_ptr(), V, d, vec, long_slots, parts,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise KernelError(f"embedding_bag_bwd kernel launch failed: CUDA error {err}")
    return out
