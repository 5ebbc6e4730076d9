"""Wrapper of the ``flash_attention`` kernels: argument checks, the launch
count, and the choice between a kernel (CUDA tensors: bfloat16 to the
wgmma kernel, float32 to the three-TF32-product one) and the plain version
(CPU tensors).

The Pallas wrapper's ``block_q``/``block_k``/``interpret``/``use_pallas``
are TPU tiling knobs and have no counterpart: the kernel picks its own
tiles."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import LAUNCH_LOCK
from repro_torch.kernels.flash_attention.ref import flash_attention_reference

HEAD_DIMS = (32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)
#: the kernel (``csrc/<name>.cu``) that serves CUDA tensors of each type
KERNEL_BY_DTYPE = {torch.bfloat16: "flash_attention_bf16",
                   torch.float32: "flash_attention_f32"}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q must be (B, Sq, H, D) and k, v "
                         f"(B, Skv, KV, D), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    _, Skv, KV, Dk = k.shape
    if k.shape[0] != B or Dk != D:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not match "
                         f"q {tuple(q.shape)} in batch or head size")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head size must be one of {HEAD_DIMS}, "
                         f"got {D}")
    if KV == 0 or H % KV:
        raise ValueError(f"flash_attention: {H} query heads are not a multiple "
                         f"of {KV} KV heads")
    if min(B, Sq, Skv) < 1 or max(B * H, Sq, Skv) >= 2**31 or Sq > 64 * 65535:
        raise ValueError(f"flash_attention: sizes B={B} Sq={Sq} Skv={Skv} H={H} "
                         f"outside what the kernel takes")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must all be float32 or all "
                         f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention: q, k, v on {q.device}, {k.device}, "
                         f"{v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if window is not None and (isinstance(window, bool) or not isinstance(window, int)
                               or abs(window) >= 2**62):
        raise ValueError(f"flash_attention: window must be None or an int, got "
                         f"{window!r}")


def kernel_name(q: torch.Tensor) -> Optional[str]:
    """The kernel that serves ``q``'s device and type, or None for the
    plain version (CPU tensors only); other devices raise."""
    if q.device.type == "cpu":
        return None
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return KERNEL_BY_DTYPE[q.dtype]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """Attention of q (B, Sq, H, D) over k, v (B, Skv, KV, D), in q's dtype.

    Query head h reads KV head ``h // (H // KV)``.  ``causal`` masks keys
    past the query (top-left: ``kv_pos <= q_pos``, q counted from 0);
    ``window`` keeps keys with ``kv_pos > q_pos - window``.  A row with no
    valid key is 0.  CUDA tensors go to a hand-written kernel
    (``kernel_name``: ``csrc/flash_attention_bf16.cu`` for bfloat16,
    ``csrc/flash_attention_f32.cu`` for float32), CPU tensors to the plain
    version.
    """
    _check(q, k, v, window)
    name = kernel_name(q)
    if name is None:
        return flash_attention_reference(q, k, v, causal, window)
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda

    out = flash_attention_cuda(name, q, k, v, causal, window)
    with LAUNCH_LOCK:
        flash_attention.launches += 1
    return out


#: kernel launches since the last reset (CPU calls do not count)
flash_attention.launches = 0
