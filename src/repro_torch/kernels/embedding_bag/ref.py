"""Plain PyTorch version of the multi-hot embedding bag.

``out[b] = sum over slots h of table[ids[b, h]]`` (``mean`` divides by H,
padded slots included).  An id outside ``[0, V)`` adds nothing, as in the
JAX package's Pallas kernel, whose one-hot count matrix matches no row for
it (the JAX package's ``jnp.take`` oracle wraps -1 to the last row and
fills NaN past V instead).  The slots are added one at a time in slot
order, which keeps memory at one (B, d) slice per slot and is the order
the CUDA kernel sums in.  The CPU path of ``ops.embedding_bag`` and the
kernel's yardstick on the card.

``embedding_bag_backward_reference`` is the gradient with respect to the
table: dense ``(V, d)``, each row the sum, in slot order from 0, of the
(mean: divided by H) output gradients of the slots that name it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.segment_spmm.ref import scatter_add


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


def bag_gradient(g_out: torch.Tensor, H: int, combiner: str) -> torch.Tensor:
    """The per-bag gradient each slot adds: ``g_out``, divided by H (a
    division, as the forward's) for ``mean``."""
    return (g_out / H if combiner == "mean" else g_out).float().contiguous()


def embedding_bag_backward_reference(g_out: torch.Tensor, ids: torch.Tensor, V: int,
                                     combiner: str = "sum") -> torch.Tensor:
    """``g_table[r] = sum over slots (b, h) with ids[b, h] == r of g[b]``,
    ``g`` the ``bag_gradient``, in slot order (b, h) from 0; an id outside
    ``[0, V)`` adds nothing; rows no id names are 0.  The port's sorted
    scatter-add (``index_add_`` on the CPU), so the sums take the same order
    on any device."""
    B, H = ids.shape
    g = bag_gradient(g_out, H, combiner)
    flat = ids.reshape(-1).long()
    slot = torch.nonzero((flat >= 0) & (flat < V)).squeeze(1)
    return scatter_add(g[slot // H], flat[slot], V)
