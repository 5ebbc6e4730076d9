"""Wrapper of the ``flash_attention`` kernels: argument checks, the launch
counts, and the choice between a kernel (CUDA tensors: bfloat16 to the
wgmma kernel, float32 to the three-TF32-product one, either's gradient to
the backward kernel) and the plain version (CPU tensors).

The Pallas wrapper's ``block_q``/``block_k``/``interpret``/``use_pallas``
are TPU tiling knobs and have no counterpart: the kernel picks its own
tiles.

Fake tensors and DTensors (``kernels.traced``) go through the
custom ops ``repro_torch::flash_attention`` and
``repro_torch::flash_attention_backward`` instead: their fake route returns
empty outputs, their FLOP formulas count the unmasked (query, key) pairs
(:func:`attention_pairs`), and their sharding rule splits by batch or by
heads, so the dry-run (``launch/hlo_analysis.py``) counts the kernels'
work without the plain version's ``S x S`` temporaries."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import LAUNCH_LOCK, sharding_rules, traced
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_backward_reference, flash_attention_reference)

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


def attention_pairs(Sq: int, Skv: int, causal: bool, window: Optional[int]) -> int:
    """The (query, key) pairs that attention with these masks computes: key
    j for query i where ``j <= i`` when causal and ``j > i - window`` when
    windowed (the plain version's ``S x S`` counts every pair).  Numpy, so
    that it runs inside a fake-tensor trace."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i, Skv - 1) if causal else np.full(Sq, Skv - 1, np.int64)
    lo = np.maximum(i - window + 1, 0) if window is not None else 0
    return int(np.maximum(hi - lo + 1, 0).sum())


def _forward(q, k, v, causal, window, with_lse: bool):
    """The output (and with ``with_lse`` the row log-sum-exp) from the
    kernel for ``q``'s device and type, or the plain version on the CPU;
    fake tensors and DTensors go through the custom op."""
    if traced(q, k, v):
        out, lse = _attention_op(q, k, v, causal, window, with_lse)
        return (out, lse) if with_lse else out
    return _launch(q, k, v, causal, window, with_lse)


def _launch(q, k, v, causal, window, with_lse: bool):
    name = kernel_name(q)
    if name is None:
        return flash_attention_reference(q, k, v, causal, window, return_lse=with_lse)
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda

    out = (flash_attention_cuda(name, q, k, v, causal, window, with_lse=True) if with_lse
           else flash_attention_cuda(name, q, k, v, causal, window))
    with LAUNCH_LOCK:
        flash_attention.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, which also writes the row log-sum-exp, and the
    backward kernel (``csrc/flash_attention_bwd.cu``) as one differentiable
    function; on CPU tensors, the plain forward and the plain explicit
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = _forward(q, k, v, causal, window, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        if not traced(do) and do.data_ptr() % 16:   # the kernel reads 16-byte aligned rows
            do = do.clone()
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, do, ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """Attention of q (B, Sq, H, D) over k, v (B, Skv, KV, D), in q's dtype.

    Query head h reads KV head ``h // (H // KV)``.  ``causal`` masks keys
    past the query (top-left: ``kv_pos <= q_pos``, q counted from 0);
    ``window`` keeps keys with ``kv_pos > q_pos - window``.  A row with no
    valid key is 0.  CUDA tensors go to a hand-written kernel
    (``kernel_name``: ``csrc/flash_attention_bf16.cu`` for bfloat16,
    ``csrc/flash_attention_f32.cu`` for float32), CPU tensors to the plain
    version.  When autograd records and q, k or v requires grad, the
    output has a ``grad_fn`` whose backward is ``flash_attention_backward``
    (the kernel then also writes the row log-sum-exp that it reads).
    """
    _check(q, k, v, window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window)
    return _forward(q, k, v, causal, window, with_lse=False)


#: forward kernel launches since the last reset (CPU calls do not count)
flash_attention.launches = 0


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                             causal: bool = True, window: Optional[int] = None):
    """``(dq, dk, dv)`` of ``flash_attention`` from its output ``o``, its
    float32 ``(B, H, Sq)`` row log-sum-exp ``lse`` and the output's
    gradient ``do``, in q's dtype.  CUDA tensors go to the hand-written
    backward kernel (``csrc/flash_attention_bwd.cu``), CPU tensors to the
    plain explicit backward."""
    _check(q, k, v, window)
    B, Sq, H, _ = q.shape
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"flash_attention_backward: {name} must be a contiguous "
                             f"tensor of q's shape, type and device")
    if (lse.shape != (B, H, Sq) or lse.dtype != torch.float32 or lse.device != q.device
            or not lse.is_contiguous()):
        raise ValueError("flash_attention_backward: lse must be a contiguous float32 "
                         f"({B}, {H}, {Sq}) tensor on q's device")
    if traced(q, k, v, do):
        return _attention_backward_op(q, k, v, o, lse, do, causal, window)
    return _launch_backward(q, k, v, o, lse, do, causal, window)


def _launch_backward(q, k, v, o, lse, do, causal, window):
    if kernel_name(q) is None:
        return flash_attention_backward_reference(q, k, v, o, lse, do, causal, window)
    from repro_torch.kernels.flash_attention.kernel import flash_attention_backward_cuda

    grads = flash_attention_backward_cuda(q, k, v, o, lse, do, causal, window)
    with LAUNCH_LOCK:
        flash_attention_backward.launches += 1
    return grads


#: backward kernel launches since the last reset (CPU calls do not count)
flash_attention_backward.launches = 0


# ---------------------------------------------------------------------------
# custom ops: the route of fake tensors and DTensors
# ---------------------------------------------------------------------------


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                  window: Optional[int], with_lse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)``, ``lse`` empty without ``with_lse``: the kernel or the
    plain version on a DTensor's local tensors."""
    if with_lse:
        out, lse = _launch(q, k, v, causal, window, True)
        return out, lse
    return _launch(q, k, v, causal, window, False), q.new_empty(0, dtype=torch.float32)


@_attention_op.register_fake
def _(q, k, v, causal, window, with_lse):
    B, Sq, H, _ = q.shape
    lse = q.new_empty((B, H, Sq) if with_lse else (0,), dtype=torch.float32)
    return torch.empty_like(q), lse


@torch.library.custom_op("repro_torch::flash_attention_backward", mutates_args=())
def _attention_backward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                           causal: bool, window: Optional[int]
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return tuple(_launch_backward(q, k, v, o, lse, do, causal, window))


@_attention_backward_op.register_fake
def _(q, k, v, o, lse, do, causal, window):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _attention_flops(q_shape, k_shape, causal, window) -> int:
    """Two products (``q k^T`` and ``p v``) over the unmasked pairs."""
    B, Sq, H, D = q_shape
    return 4 * B * H * D * attention_pairs(Sq, k_shape[1], causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _(q_shape, k_shape, v_shape, causal, window, with_lse, *args, **kwargs) -> int:
    return _attention_flops(q_shape, k_shape, causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_attention_backward)
def _(q_shape, k_shape, v_shape, o_shape, lse_shape, do_shape, causal, window,
      *args, **kwargs) -> int:
    # five products: the scores again, dv, the probabilities' gradient, dq, dk
    return 5 * _attention_flops(q_shape, k_shape, causal, window) // 2


@sharding_rules
def _register_sharding() -> None:
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.flash_attention.default)
    def _(q, k, v, causal, window, with_lse):
        # replicated, by batch, or by heads (query and KV heads split alike)
        rules = [([Replicate(), Replicate()], [Replicate()] * 3 + [None] * 3),
                 ([Shard(0), Shard(0) if with_lse else Replicate()],
                  [Shard(0)] * 3 + [None] * 3),
                 ([Shard(2), Shard(1) if with_lse else Replicate()],
                  [Shard(2)] * 3 + [None] * 3)]
        return rules

    @register_sharding(torch.ops.repro_torch.flash_attention_backward.default)
    def _(q, k, v, o, lse, do, causal, window):
        return [([Replicate()] * 3, [Replicate()] * 6 + [None] * 2),
                ([Shard(0)] * 3, [Shard(0)] * 6 + [None] * 2),
                ([Shard(2)] * 3, [Shard(2)] * 3 + [Shard(2), Shard(1), Shard(2)] + [None] * 2)]


