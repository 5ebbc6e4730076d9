"""ctypes bindings of the two hand-written CUDA ``flash_attention`` kernels.

Both replace the TPU kernel
``src/repro/kernels/flash_attention/kernel.py::_attn_kernel``, one per
input type; see each source for its design:

  flash_attention_bf16 — ``csrc/flash_attention_bf16.cu``: bfloat16 on the
      tensor cores (wgmma, TMA, mbarrier pipeline, warp specialisation), the
      serving path's kernel;
  flash_attention_f32  — ``csrc/flash_attention_f32.cu``: float32 on the
      tensor cores as three TF32 products per product (mma.sync, cp.async
      double buffering; the float32 model and its whole-path gate).

The shared libraries are built from the checkout at first use
(``kernels/build.py``) and launched on PyTorch's current stream.
``TILE_PLAN`` and ``TILE_PLAN_F32`` are the two kernels' tilings per head
size; each source instantiates exactly its plans and rejects any other.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.kernels import KernelError


class TilePlan(NamedTuple):
    bq: int        # q rows per block (two consumer warpgroups of 64)
    bk: int        # kv rows per tile
    stages: int    # K/V tiles in flight


#: the bf16 kernel's tiles per head size D: 128 x 128 at D = 128 (the
#: serving path's); BK = 64 elsewhere, where the scores, P's two bf16 parts
#: and O would not fit a consumer thread's registers with BK = 128 (at
#: D = 256 O alone takes 128); two K/V stages everywhere
TILE_PLAN: Dict[int, TilePlan] = {32: TilePlan(128, 64, 2), 64: TilePlan(128, 64, 2),
                                  128: TilePlan(128, 128, 2), 256: TilePlan(128, 64, 2)}
#: the float32 kernel's tiles per head size D: 64 q rows (four warps of 16)
#: and two K/V tiles in flight everywhere; 64 keys a tile up to D = 64, 32
#: above, where two 64-key K and V tiles with the Q tile would leave room
#: for one block an SM (D = 128) or not fit (D = 256)
TILE_PLAN_F32: Dict[int, TilePlan] = {32: TilePlan(64, 64, 2), 64: TilePlan(64, 64, 2),
                                      128: TilePlan(64, 32, 2), 256: TilePlan(64, 32, 2)}
#: each kernel's plans by name
TILE_PLANS = {"flash_attention_bf16": TILE_PLAN, "flash_attention_f32": TILE_PLAN_F32}
#: shared memory one block may use on an H100 (227 KB)
SMEM_LIMIT = 232448


def smem_bytes(d: int, plan: TilePlan) -> int:
    """Dynamic shared memory of the bf16 kernel at head size ``d``: 1,024
    bytes of alignment slack, the bf16 Q tile, ``stages`` K and V tiles and
    128 bytes of mbarriers (the source's ``Plan::kSmem``)."""
    return 1024 + 2 * d * (plan.bq + 2 * plan.stages * plan.bk) + 128


def smem_bytes_f32(d: int, plan: TilePlan) -> int:
    """Dynamic shared memory of the float32 kernel at head size ``d``: the
    float32 Q tile and ``stages`` K tiles at a row stride of d + 16 floats,
    ``stages`` V tiles at d + 4 (the source's ``Plan::kSmem``)."""
    return 4 * ((plan.bq + plan.stages * plan.bk) * (d + 16) + plan.stages * plan.bk * (d + 4))


@functools.lru_cache(maxsize=None)
def _launcher(name: str):
    from repro_torch.kernels.build import load

    fn = getattr(load(name), f"{name}_launch")
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                   + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, window: Optional[int]) -> torch.Tensor:
    """Launch kernel ``name`` (``flash_attention_bf16`` or
    ``flash_attention_f32``); arguments are checked by
    ``ops.flash_attention``."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    for t in (q, k, v, out):
        if t.data_ptr() % 16:
            raise ValueError("flash_attention: the kernel takes 16-byte aligned "
                             "tensors (a view at an odd offset is not one)")
    plan = TILE_PLANS[name][D]
    scale_log2 = math.log2(math.e) / math.sqrt(D)
    with torch.cuda.device(q.device):
        err = _launcher(name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Skv, H, KV, D, plan.bk, plan.stages, int(causal), int(window is not None),
            0 if window is None else window, scale_log2,
            torch.cuda.current_stream().cuda_stream)
    if err >= 10000:
        raise KernelError(f"{name}: cuTensorMapEncodeTiled failed: CUresult {err - 10000}")
    if err != 0:
        raise KernelError(f"{name} kernel launch failed: CUDA error {err}")
    return out
