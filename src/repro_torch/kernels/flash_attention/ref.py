"""Plain PyTorch version of the flash-attention kernel.

The semantics of the Pallas kernel (``src/repro/kernels/flash_attention``)
and of its oracle ``ref.py::attention_reference``: q (B, Sq, H, D), k and v
(B, Skv, KV, D), query head h reads KV head ``h // (H // KV)``; scores
``(q . k) / sqrt(D)`` in float32; the causal mask is top-left aligned
(``kv_pos <= q_pos``, q counted from 0) and the window one-sided
(``kv_pos > q_pos - window``); a row with no valid key gives exactly 0.
q, k and v are converted to float32, the output is in q's dtype.

It runs in chunks of ``chunk`` query rows, each with its full float32 score
block (B, KV, G * chunk, Skv), so that it runs at a 32k-token prefill on the
card (a full (H, S, S) float32 score tensor there is 137 GB).  GQA is a
reshape of the query heads onto their KV head, not a repeated K/V.  The CPU
path of ``ops.flash_attention`` and the kernel's yardstick on the card.

``flash_attention_backward_reference`` is the backward, by explicit
formulas from the forward's saved row log-sum-exp, in the same chunks: the
CPU path of the wrapper's backward and the backward kernel's yardstick.
Both work in place on their score blocks, so neither can be differentiated
by autograd; the wrapper (``ops.flash_attention``) pairs them as one
``torch.autograd.Function``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _mask(q0: int, c: int, Skv: int, causal: bool, window: Optional[int],
          device) -> torch.Tensor:
    """(c, Skv): which keys query rows q0 .. q0 + c - 1 may see."""
    kv_pos = torch.arange(Skv, device=device)
    q_pos = torch.arange(q0, q0 + c, device=device)[:, None]
    mask = torch.ones((c, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kv_pos[None, :] <= q_pos
    if window is not None:
        mask &= kv_pos[None, :] > q_pos - window
    return mask


def _rows(x: torch.Tensor, q0: int, c: int, KV: int) -> torch.Tensor:
    """Rows q0 .. q0 + c - 1 of x (B, Sq, H, D) in float32 as (B, KV, G * c,
    D): one KV head's query heads, ordered (g, q)."""
    B, _, H, D = x.shape
    return (x[:, q0:q0 + c].float().reshape(B, c, KV, H // KV, D)
            .permute(0, 2, 3, 1, 4).reshape(B, KV, H // KV * c, D))


def _unrows(x: torch.Tensor, c: int, H: int) -> torch.Tensor:
    """``_rows``' inverse: (B, KV, G * c, D) to (B, c, H, D)."""
    B, KV, _, D = x.shape
    return x.view(B, KV, H // KV, c, D).permute(0, 3, 1, 2, 4).reshape(B, c, H, D)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              causal: bool = True, window: Optional[int] = None,
                              chunk: int = 1024, return_lse: bool = False):
    """The output (B, Sq, H, D) in q's dtype; with ``return_lse`` also each
    row's float32 log-sum-exp of its scaled scores, (B, H, Sq), natural log,
    -inf on a row with no valid key (the output is the same either way)."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    kf = k.float().permute(0, 2, 3, 1).contiguous()       # (B, KV, D, Skv)
    vf = v.float().permute(0, 2, 1, 3).contiguous()       # (B, KV, Skv, D)
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    for q0 in range(0, Sq, chunk):
        c = min(chunk, Sq - q0)
        s = (_rows(q, q0, c, KV) @ kf).mul_(scale)         # (B, KV, G*c, Skv)
        mask = _mask(q0, c, Skv, causal, window, q.device)
        s = s.view(B, KV, G, c, Skv).masked_fill_(~mask, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = s.sub_(m).exp_().masked_fill_(~mask, 0.0)     # in place: one score block
        l = p.sum(dim=-1, keepdim=True)
        o = (p.view(B, KV, G * c, Skv) @ vf).view(B, KV, G, c, D)
        o = o / torch.clamp(l, min=1e-30)
        out[:, q0:q0 + c] = o.permute(0, 3, 1, 2, 4).reshape(B, c, H, D).to(q.dtype)
        if lse is not None:
            lse[:, :, q0:q0 + c] = (m + torch.log(l)).view(B, H, c)
    return (out, lse) if return_lse else out


def flash_attention_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                       o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                                       causal: bool = True, window: Optional[int] = None,
                                       chunk: int = 1024):
    """``(dq, dk, dv)`` of the attention above, in q's dtype, by explicit
    formulas (not autograd), chunk by chunk of query rows in float32 from
    the forward's output ``o`` and row log-sum-exp ``lse`` (B, H, Sq):

        p = exp(s - lse) where the mask holds, 0 elsewhere
        delta = rowsum(do * o);  ds = p * (do v^T - delta)
        dv = p^T do;  dk = ds^T q / sqrt(D);  dq = ds k / sqrt(D)

    A row with no valid key has p = 0 and gets zero gradient.  The CPU path
    of the ``flash_attention`` wrapper's backward and the backward kernel's
    yardstick on the card."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    kf = k.float().permute(0, 2, 1, 3)                    # (B, KV, Skv, D)
    vf = v.float().permute(0, 2, 1, 3)
    dq = torch.empty_like(q)
    dk = torch.zeros((B, KV, Skv, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for q0 in range(0, Sq, chunk):
        c = min(chunk, Sq - q0)
        qc, doc = _rows(q, q0, c, KV), _rows(do, q0, c, KV)
        delta = (doc * _rows(o, q0, c, KV)).sum(dim=-1, keepdim=True)
        mask = _mask(q0, c, Skv, causal, window, q.device)
        rows_lse = lse[:, :, q0:q0 + c].reshape(B, KV, G, c, 1)
        s = (qc @ kf.transpose(-1, -2)).mul_(scale).view(B, KV, G, c, Skv)
        p = s.sub_(rows_lse).exp_().masked_fill_(~mask, 0.0).view(B, KV, G * c, Skv)
        ds = (doc @ vf.transpose(-1, -2)).sub_(delta).mul_(p)
        dv += p.transpose(-1, -2) @ doc
        dk += ds.transpose(-1, -2) @ qc
        dq[:, q0:q0 + c] = _unrows((ds @ kf).mul_(scale), c, H).to(q.dtype)
    dk = dk.mul_(scale).permute(0, 2, 1, 3).to(k.dtype)
    return dq, dk, dv.permute(0, 2, 1, 3).to(v.dtype)
