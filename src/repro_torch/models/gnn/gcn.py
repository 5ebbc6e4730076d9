"""GCN (Kipf & Welling, arXiv:1609.02907) — SpMM kernel regime.

X' = act( norm(A + I) X W + b ); sym norm D^-1/2 (A+I) D^-1/2 or mean D^-1 A.

The aggregation ``scatter_sum(gather(x, src) * coeff, dst, n, emask)`` of
the JAX package is one ``segment_spmm`` launch per layer over the graph's
destination-sorted CSR, with weight ``coeff * emask`` per edge; the self
term is added after.  A masked edge (a self loop) gets weight 0 and is
left out of the degrees.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.segment_spmm.ops import (EdgeCSR, csr_from_edges,
                                                  segment_spmm_csr)
from repro_torch.models.gnn.common import degrees


def init(cfg: GNNConfig, d_in: int, seed: int = 0,
         device: DeviceLike = None) -> Dict:
    """``{"layers": [{"w", "b"}, ...]}``, ``w ~ N(0, 1/a)`` from a seeded
    ``torch.Generator`` on ``device`` (default ``"cuda"``)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dims = [d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    layers = []
    for a, b in zip(dims, dims[1:]):
        w = torch.randn((a, b), generator=gen, device=device) / math.sqrt(a)
        layers.append({"w": w, "b": torch.zeros((b,), device=device)})
    return {"layers": layers}


def graph_csr(batch: Dict) -> EdgeCSR:
    """The batch's destination-sorted CSR, built on its device; compute it
    once per graph and pass it to every :func:`forward`."""
    return csr_from_edges(batch["edge_src"], batch["edge_dst"],
                          batch["node_feat"].shape[0])


def forward(params, batch: Dict, cfg: GNNConfig,
            csr: Optional[EdgeCSR] = None) -> torch.Tensor:
    """Node logits ``(N, n_classes)``; ``batch`` holds tensors on one
    device, ``csr`` its :func:`graph_csr` (built here when omitted)."""
    x = batch["node_feat"]
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    emask, nmask = batch["edge_mask"], batch["node_mask"]
    n = x.shape[0]
    deg = degrees(dst, n, emask) + 1.0  # +1: self loop
    if cfg.norm == "sym":
        inv_sqrt = torch.rsqrt(deg)
        coeff = inv_sqrt[src] * inv_sqrt[dst]
        self_coeff = 1.0 / deg
    else:  # mean aggregator
        coeff = 1.0 / deg[dst]
        self_coeff = 1.0 / deg
    if csr is None:
        csr = graph_csr(batch)
    w = (coeff * emask)[csr.order]
    for i, p in enumerate(params["layers"]):
        agg = segment_spmm_csr(x, csr, w) + x * self_coeff[:, None]
        x = agg @ p["w"] + p["b"]
        if i < len(params["layers"]) - 1:
            x = torch.relu(x)
    return x * nmask[:, None]
