"""ctypes binding of the hand-written CUDA ``segment_spmm`` kernel.

The kernel (``kernels/csrc/segment_spmm.cu``) replaces the TPU kernel
``src/repro/kernels/segment_spmm/kernel.py::_spmm_kernel``; see the source
for its design.  The shared library is built from the checkout at first
use (``kernels/build.py``) and launched on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
import functools

import torch


@functools.lru_cache(maxsize=None)
def _launcher():
    from repro_torch.kernels.build import load

    fn = load("segment_spmm").segment_spmm_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def segment_spmm_cuda(x: torch.Tensor, row_ptr: torch.Tensor,
                      src: torch.Tensor, w: torch.Tensor, vec: int) -> torch.Tensor:
    """Launch the kernel; arguments are checked by ``ops.segment_spmm_csr``,
    ``vec`` (4: float4 loads, 1: scalar) chosen by ``ops.vector_width``."""
    n_rows, F = row_ptr.shape[0] - 1, x.shape[1]
    out = torch.empty((n_rows, F), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _launcher()(
            row_ptr.data_ptr(), src.data_ptr(), w.data_ptr(), x.data_ptr(),
            out.data_ptr(), n_rows, F, vec, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment_spmm kernel launch failed: CUDA error {err}")
    return out
