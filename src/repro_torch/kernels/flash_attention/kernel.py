"""ctypes binding of the hand-written CUDA ``flash_attention`` kernel.

The kernel (``kernels/csrc/flash_attention.cu``) replaces the TPU kernel
``src/repro/kernels/flash_attention/kernel.py::_attn_kernel``; see the
source for its design.  The shared library is built from the checkout at
first use (``kernels/build.py``) and launched on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch


@functools.lru_cache(maxsize=None)
def _launcher():
    from repro_torch.kernels.build import load

    fn = load("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, window: Optional[int]) -> torch.Tensor:
    """Launch the kernel; arguments are checked by ``ops.flash_attention``."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    for t in (q, k, v, out):
        if t.data_ptr() % 16:
            raise ValueError("flash_attention: the kernel takes 16-byte aligned "
                             "tensors (a view at an odd offset is not one)")
    with torch.cuda.device(q.device):
        err = _launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Skv, H, KV, D, int(causal), int(window is not None),
            0 if window is None else window, int(q.dtype == torch.bfloat16),
            1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    return out
