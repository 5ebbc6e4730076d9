"""Shared GNN substrate: batch container, segment message passing, MLPs.

The JAX package builds its aggregation on ``jax.ops.segment_sum`` with the
``segment_spmm`` Pallas kernel as the TPU twin; here the plain scatter is
``index_add_`` and the models' weighted aggregation runs as the port's
``segment_spmm`` CUDA kernel (``models/gnn/gcn.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F


@dataclass
class GraphBatch:
    """Padded (possibly batched) graph.

    node_feat: (N, F) float; positions: (N, 3) or None; edge_src/dst: (E,)
    int32 (padded entries masked); graph_id: (N,) int32 for pooled readout;
    targets: (N,) or (G,) — node labels / graph labels / energies.
    """

    node_feat: torch.Tensor
    edge_src: torch.Tensor
    edge_dst: torch.Tensor
    node_mask: torch.Tensor
    edge_mask: torch.Tensor
    targets: torch.Tensor
    positions: Optional[torch.Tensor] = None
    graph_id: Optional[torch.Tensor] = None
    n_graphs: int = 1

    def as_dict(self) -> Dict:
        out = {
            "node_feat": self.node_feat,
            "edge_src": self.edge_src,
            "edge_dst": self.edge_dst,
            "node_mask": self.node_mask,
            "edge_mask": self.edge_mask,
            "targets": self.targets,
        }
        if self.positions is not None:
            out["positions"] = self.positions
        if self.graph_id is not None:
            out["graph_id"] = self.graph_id
        return out


def scatter_sum(values: torch.Tensor, index: torch.Tensor, n: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Segment sum with optional edge mask; values (E, ...), index (E,)."""
    if mask is not None:
        values = values * mask.reshape((-1,) + (1,) * (values.dim() - 1))
        index = torch.where(mask, index, n)  # park masked edges in a waste bin
        n_bins = n + 1
    else:
        n_bins = n
    out = values.new_zeros((n_bins,) + tuple(values.shape[1:]))
    return out.index_add_(0, index.long(), values)[:n]


def degrees(edge_dst: torch.Tensor, n: int,
            edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    ones = torch.ones(edge_dst.shape, dtype=torch.float32, device=edge_dst.device)
    return scatter_sum(ones, edge_dst, n, edge_mask)


def gather(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    return x.index_select(0, index.long())


def mlp_init(dims: Sequence[int], generator: torch.Generator,
             device: torch.device, dtype=torch.float32) -> List[Dict]:
    """Dense layers ``w ~ N(0, 1/a)``, ``b = 0`` for consecutive ``dims``."""
    params = []
    for a, b in zip(dims, dims[1:]):
        w = torch.randn((a, b), generator=generator, device=device) / math.sqrt(a)
        params.append({"w": w.to(dtype),
                       "b": torch.zeros((b,), dtype=dtype, device=device)})
    return params


def mlp_apply(params, x, act=F.silu, final_act=False):
    for i, p in enumerate(params):
        x = x @ p["w"] + p["b"]
        if i < len(params) - 1 or final_act:
            x = act(x)
    return x
