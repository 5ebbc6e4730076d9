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
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              causal: bool = True, window: Optional[int] = None,
                              chunk: int = 1024) -> torch.Tensor:
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    kf = k.float().permute(0, 2, 3, 1).contiguous()       # (B, KV, D, Skv)
    vf = v.float().permute(0, 2, 1, 3).contiguous()       # (B, KV, Skv, D)
    kv_pos = torch.arange(Skv, device=q.device)
    out = torch.empty_like(q)
    for q0 in range(0, Sq, chunk):
        c = min(chunk, Sq - q0)
        # rows of one KV head's query heads, ordered (g, q)
        qc = q[:, q0:q0 + c].float().reshape(B, c, KV, G, D).permute(0, 2, 3, 1, 4)
        s = (qc.reshape(B, KV, G * c, D) @ kf).mul_(scale)  # (B, KV, G*c, Skv)
        q_pos = torch.arange(q0, q0 + c, device=q.device)[:, None]
        mask = torch.ones((c, Skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kv_pos[None, :] <= q_pos
        if window is not None:
            mask &= kv_pos[None, :] > q_pos - window
        s = s.view(B, KV, G, c, Skv).masked_fill_(~mask, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = s.sub_(m).exp_().masked_fill_(~mask, 0.0)     # in place: one score block
        l = p.sum(dim=-1, keepdim=True)
        o = (p.view(B, KV, G * c, Skv) @ vf).view(B, KV, G, c, D)
        o = o / torch.clamp(l, min=1e-30)
        out[:, q0:q0 + c] = o.permute(0, 3, 1, 2, 4).reshape(B, c, H, D).to(q.dtype)
    return out
