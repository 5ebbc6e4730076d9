"""Plain PyTorch version of the multi-hot embedding bag.

``out[b] = sum over slots h of table[ids[b, h]]`` (``mean`` divides by H,
padded slots included).  An id outside ``[0, V)`` adds nothing, as in the
JAX package's Pallas kernel, whose one-hot count matrix matches no row for
it (the JAX package's ``jnp.take`` oracle wraps -1 to the last row and
fills NaN past V instead).  The slots are added one at a time in slot
order, which keeps memory at one (B, d) slice per slot and is the order
the CUDA kernel sums in.  The CPU path of ``ops.embedding_bag`` and the
kernel's yardstick on the card.
"""
from __future__ import annotations

import torch


def embedding_bag_reference(table: torch.Tensor, ids: torch.Tensor,
                            combiner: str = "sum") -> torch.Tensor:
    V = table.shape[0]
    B, H = ids.shape
    out = torch.zeros((B, table.shape[1]), dtype=table.dtype, device=table.device)
    for h in range(H):
        col = ids[:, h].long()
        valid = (col >= 0) & (col < V)
        rows = table[torch.where(valid, col, 0)]
        out = out + torch.where(valid[:, None], rows, 0.0)
    if combiner == "mean":
        out = out / H
    return out
