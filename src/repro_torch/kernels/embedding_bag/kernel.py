"""ctypes binding of the hand-written CUDA ``embedding_bag`` kernel.

The kernel (``kernels/csrc/embedding_bag.cu``) replaces the TPU kernel
``src/repro/kernels/embedding_bag/kernel.py::_bag_kernel``; see the source
for its design.  The shared library is built from the checkout at first
use (``kernels/build.py``) and launched on PyTorch's current stream.
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
