"""ctypes binding of the hand-written CUDA ``vm_step`` kernel.

The kernel (``kernels/csrc/vm_step.cu``) replaces the TPU kernel
``src/repro/kernels/vm_step/kernel.py::_vm_kernel``; see the source for its
design.  The shared library is built from the checkout at first use
(``kernels/build.py``) and launched on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
import functools

import torch


@functools.lru_cache(maxsize=None)
def _launcher():
    from repro_torch.kernels.build import load

    fn = load("vm_step").vm_step_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p, ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def vm_step_cuda(alpha: torch.Tensor, par: torch.Tensor, val: torch.Tensor,
                 row_ptr: torch.Tensor, src: torch.Tensor, w: torch.Tensor,
                 row_label: torch.Tensor, runs: torch.Tensor,
                 long_rows: torch.Tensor) -> torch.Tensor:
    """Launch the kernel; arguments are checked by ``ops.vm_step``.
    ``runs`` and ``long_rows`` are the ``ops.RowPlan`` of ``row_ptr``.
    The output has ``row_ptr.shape[0] - 1`` rows; ``alpha`` may have more."""
    n_in, N = alpha.shape
    n_out = row_ptr.shape[0] - 1
    out = torch.empty((n_out, N), dtype=alpha.dtype, device=alpha.device)
    with torch.cuda.device(alpha.device):
        err = _launcher()(
            row_ptr.data_ptr(), src.data_ptr(), w.data_ptr(),
            row_label.data_ptr(), alpha.data_ptr(), par.data_ptr(),
            val.data_ptr(), out.data_ptr(), n_out, n_in, N, par.shape[0],
            runs.data_ptr(), runs.shape[0] - 1, long_rows.data_ptr(),
            long_rows.shape[0],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"vm_step kernel launch failed: CUDA error {err}")
    return out
