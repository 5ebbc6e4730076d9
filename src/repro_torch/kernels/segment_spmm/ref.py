"""Plain PyTorch version of the edge-weighted gather-scatter SpMM.

``out[dst] += w_e * x[src]`` — the GNN message-passing primitive.  Edges go
through in chunks so the (E, F) message tensor never exists whole (61.9M
edges x 100 features would be 24.7 GB); ``index_add_`` adds each chunk's
messages in edge order on the CPU.  ``segment_spmm_csr_reference`` is
the CPU path of ``ops.segment_spmm_csr`` and the kernel's yardstick on the
card.
"""
from __future__ import annotations

import torch

#: edges per chunk of the message tensor
CHUNK = 1 << 22


def segment_spmm_reference(
    x: torch.Tensor,          # (n, F) node features
    edge_src: torch.Tensor,   # (E,) int
    edge_dst: torch.Tensor,   # (E,) int
    edge_w: torch.Tensor,     # (E,) float
    n_out: int,
) -> torch.Tensor:
    out = torch.zeros((n_out, x.shape[1]), dtype=x.dtype, device=x.device)
    for lo in range(0, edge_src.shape[0], CHUNK):
        s, d = edge_src[lo:lo + CHUNK].long(), edge_dst[lo:lo + CHUNK].long()
        msgs = x[s] * edge_w[lo:lo + CHUNK, None].to(x.dtype)
        out.index_add_(0, d, msgs)
    return out


def segment_spmm_csr_reference(x: torch.Tensor, row_ptr: torch.Tensor,
                               src: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same function over a destination-sorted CSR: ``(n_rows, F)``."""
    n_rows = row_ptr.shape[0] - 1
    dst = torch.repeat_interleave(
        torch.arange(n_rows, device=x.device), (row_ptr[1:] - row_ptr[:-1]).long())
    return segment_spmm_reference(x, src, dst, w, n_rows)
