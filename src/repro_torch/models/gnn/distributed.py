"""Partition-aware distributed GNN execution: halo exchange accounting.

When graph nodes are sharded over devices, every message-passing layer
must fetch the features of *remote* neighbours ("halo" rows) — the
distributed-GNN incarnation of the paper's inter-partition traversals.
Halo volume per layer is exactly the number of (partition,
remote-neighbour) pairs, so a TAPER-refined placement directly reduces the
all-to-all bytes.

``HaloPlan`` computes the exchange plan (numpy); ``partitioned_gcn_forward``
runs a GCN with explicit per-partition halo gathers — the execution
semantics a sharded deployment uses — each partition's aggregation one
``segment_spmm`` launch over that partition's edges, the partial sums
added in partition order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.graphs.graph import LabelledGraph
from repro_torch.kernels.segment_spmm.ops import csr_from_edges, segment_spmm_csr


@dataclass
class HaloPlan:
    k: int
    halo_rows: List[np.ndarray]        # per partition: remote node ids needed
    total_halo_rows: int
    bytes_per_layer: int               # at d_hidden fp32

    @staticmethod
    def build(g: LabelledGraph, part: np.ndarray, d_hidden: int,
              k: int) -> "HaloPlan":
        halo_rows = []
        total = 0
        for p in range(k):
            mask = part[g.dst] == p
            remote = part[g.src] != p
            rows = np.unique(g.src[mask & remote])
            halo_rows.append(rows)
            total += rows.size
        return HaloPlan(k, halo_rows, total, total * d_hidden * 4)


def partitioned_gcn_forward(params, g: LabelledGraph, part: np.ndarray,
                            x: np.ndarray, cfg: GNNConfig,
                            k: int) -> Tuple[torch.Tensor, int]:
    """GCN forward executed partition-by-partition with explicit halo
    gathers, on the device of ``params`` (the port's GCN tree).

    Partition p's edges (those whose destination it owns) form one
    destination-sorted CSR, weights ``deg^-1/2[src] deg^-1/2[dst]``; each
    layer sums ``segment_spmm_csr`` over them partition by partition, in
    partition order, then adds the self term.  Returns (logits,
    halo_bytes_total)."""
    dev = params["layers"][0]["w"].device
    n = g.n
    deg = np.zeros(n)
    np.add.at(deg, g.dst, 1.0)
    deg += 1.0
    inv_sqrt = 1.0 / np.sqrt(deg)
    self_coeff = torch.as_tensor((1.0 / deg).astype(np.float32), device=dev)

    shards = []
    for p in range(k):
        emask = part[g.dst] == p
        src, dst = g.src[emask], g.dst[emask]
        csr = csr_from_edges(torch.as_tensor(src, device=dev),
                             torch.as_tensor(dst, device=dev), n)
        coeff = torch.as_tensor((inv_sqrt[src] * inv_sqrt[dst]).astype(np.float32),
                                device=dev)
        shards.append((csr, coeff[csr.order].contiguous()))

    halo_rows = HaloPlan.build(g, part, 1, k).total_halo_rows
    halo_bytes = 0
    h = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    for li, p_layer in enumerate(params["layers"]):
        halo_bytes += halo_rows * h.shape[1] * 4
        agg = torch.zeros_like(h)
        for csr, w in shards:
            # local + halo rows are read per partition ("the exchange")
            agg = agg + segment_spmm_csr(h, csr, w)
        agg = agg + h * self_coeff[:, None]
        h = agg @ p_layer["w"] + p_layer["b"]
        if li < len(params["layers"]) - 1:
            h = torch.relu(h)
    return h, halo_bytes


def halo_bytes_per_step(g: LabelledGraph, part: np.ndarray, cfg: GNNConfig,
                        d_feat: int, k: int) -> int:
    """Total halo bytes for one forward pass (layer dims vary)."""
    dims = [d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1)
    total = 0
    for d in dims:
        total += HaloPlan.build(g, part, d, k).total_halo_rows * d * 4
    return total
