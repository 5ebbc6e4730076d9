"""ctypes bindings of the hand-written CUDA ``flash_attention`` kernels: two
forward kernels and the backward.

The forward kernels replace the TPU kernel
``src/repro/kernels/flash_attention/kernel.py::_attn_kernel``, one per
input type; see each source for its design:

  flash_attention_bf16 — ``csrc/flash_attention_bf16.cu``: bfloat16 on the
      tensor cores (wgmma, TMA, mbarrier pipeline, warp specialisation), the
      serving path's kernel;
  flash_attention_f32  — ``csrc/flash_attention_f32.cu``: float32 on the
      tensor cores as three TF32 products per product (mma.sync, cp.async
      double buffering; the float32 model and its whole-path gate);
  flash_attention_bwd  — ``csrc/flash_attention_bwd.cu``: the backward of
      either (dq, dk, dv from q, k, v, o, the forward's row log-sum-exp and
      the output's gradient), every product on the tensor cores: bf16 at
      head sizes up to 128 on wgmma (TMA, mbarriers: delta, then dv, dk
      and dq launches), float32 as three TF32 ``mma.sync`` products and
      bf16 at 256 as one bf16 ``mma.sync`` product, on the same delta, dv,
      dk and dq launches over ``cp.async`` double-buffered tiles; it
      replaces no TPU kernel (the JAX package differentiates its plain
      ``jnp`` attention).

The shared libraries are built from the checkout at first use
(``kernels/build.py``) and launched on PyTorch's current stream.
``TILE_PLAN`` and ``TILE_PLAN_F32`` are the two forward kernels' tilings
per head size, ``TILE_PLAN_BWD_F32`` the backward's ``mma.sync`` route's;
each source instantiates exactly its plans and rejects any other.
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


class BwdTilePlan(NamedTuple):
    bq: int        # q rows a step of a dv or dk block (BWD_ROWS keys)
    bk: int        # keys a step of a dq block (BWD_ROWS q rows)
    stages: int    # steps in flight (cp.async)


#: rows a block of the backward's mma.sync route owns: four warps of 16
#: (keys in the dv and dk launches, q rows in the dq launch)
BWD_ROWS = 64
#: the backward's float32 tiles per head size D (bf16 at D = 256 takes the
#: same): a warp's s^T of 16 keys x bq rows in three accumulators of bq / 2
#: registers; 32-row steps up to D = 64, 16 above, where the dk block's K
#: and V with two 32-row steps of q and dout would leave one block an SM
#: (D = 128) or not fit (D = 256)
TILE_PLAN_BWD_F32: Dict[int, BwdTilePlan] = {
    32: BwdTilePlan(32, 32, 2), 64: BwdTilePlan(32, 32, 2),
    128: BwdTilePlan(16, 16, 2), 256: BwdTilePlan(16, 16, 2)}
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


def smem_bytes_bwd_f32(d: int, plan: BwdTilePlan, itemsize: int = 4) -> int:
    """Dynamic shared memory of the backward's ``mma.sync`` route at head
    size ``d``, the largest of its launches (the source's ``MmaPlan``): rows
    staged at ``d`` elements plus 16 bytes; dk holds K and V of its
    BWD_ROWS keys, ``stages`` steps of q and dout (``bq`` rows) and their
    lse and delta; dq q and dout of its BWD_ROWS rows and ``stages`` steps
    of K and V (``bk`` rows).  ``itemsize`` 2 for bf16."""
    row = itemsize * d + 16
    dk = 2 * BWD_ROWS * row + 2 * plan.stages * plan.bq * row + 8 * plan.stages * plan.bq
    dq = 2 * BWD_ROWS * row + 2 * plan.stages * plan.bk * row
    return max(dk, dq)


@functools.lru_cache(maxsize=None)
def _launcher(name: str):
    from repro_torch.kernels.build import load

    fn = getattr(load(name), f"{name}_launch")
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                   + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, window: Optional[int], with_lse: bool = False):
    """Launch kernel ``name`` (``flash_attention_bf16`` or
    ``flash_attention_f32``); arguments are checked by
    ``ops.flash_attention``.  Returns the output, or with ``with_lse`` the
    output and the float32 ``(B, H, Sq)`` row log-sum-exp the kernel also
    writes then (the output is the same either way)."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
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
            None if lse is None else lse.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err >= 10000:
        raise KernelError(f"{name}: cuTensorMapEncodeTiled failed: CUresult {err - 10000}")
    if err != 0:
        raise KernelError(f"{name} kernel launch failed: CUDA error {err}")
    return (out, lse) if with_lse else out


@functools.lru_cache(maxsize=None)
def _bwd_launcher(parts: bool = False):
    """The backward's entry point, or with ``parts`` the one that launches
    a chosen subset of the bf16 tensor-core route's four launches."""
    from repro_torch.kernels.build import load

    lib = load("flash_attention_bwd")
    if parts:
        fn = lib.flash_attention_bwd_launch_parts
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                       + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p, ctypes.c_int])
    else:
        fn = lib.flash_attention_bwd_launch
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                       + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_backward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                                  causal: bool, window: Optional[int]):
    """Launch ``csrc/flash_attention_bwd.cu`` (delta, dv, dk, then dq);
    returns ``(dq, dk, dv)`` in q's dtype.  Arguments are checked by
    ``ops.flash_attention_backward``."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    for t in (q, k, v, o, do):
        if t.data_ptr() % 16:
            raise ValueError("flash_attention_backward: the kernel takes 16-byte aligned "
                             "tensors (a view at an odd offset is not one)")
    with torch.cuda.device(q.device):
        err = _bwd_launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, Sq, Skv, H, KV, D, int(q.dtype == torch.bfloat16), int(causal),
            int(window is not None), 0 if window is None else window, 1.0 / math.sqrt(D),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise KernelError(f"flash_attention_bwd kernel launch failed: CUDA error {err}")
    return dq, dk, dv


#: the bf16 tensor-core route's launches, by their bit in ``parts``
BWD_PARTS = {"delta": 1, "dv": 2, "dk": 4, "dq": 8}


def flash_attention_backward_parts_cuda(q, k, v, o, lse, do, delta, grads, causal: bool,
                                        window: Optional[int], parts: int) -> None:
    """Launch the launches of the bf16 backward (head size 32, 64 or 128)
    whose bits ``parts`` sets (``BWD_PARTS``), in their order, into the
    float32 ``(B, H, Sq)`` ``delta`` and ``grads = (dq, dk, dv)``: dk and dq
    read ``delta``, so a launch of them alone needs one of delta before it.
    For timing each launch alone; the wrapper's launch count is not
    touched."""
    B, Sq, H, D = q.shape
    dq, dk, dv = grads
    with torch.cuda.device(q.device):
        err = _bwd_launcher(True)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, Sq, k.shape[1], H, k.shape[2], D, int(causal), int(window is not None),
            0 if window is None else window, 1.0 / math.sqrt(D),
            torch.cuda.current_stream().cuda_stream, parts)
    if err != 0:
        raise KernelError(f"flash_attention_bwd_launch_parts({parts}) failed: error {err}")
