"""GIN (Xu et al., arXiv:1810.00826) — sum-aggregation SpMM + MLP.

h' = MLP( (1 + eps) h + sum_{u in N(v)} h_u ), eps learnable; graph-level
readout by per-layer sum pooling (jumping knowledge), linear classifier.

The neighbour sum ``scatter_sum(gather(x, src), dst, n, emask)`` of the JAX
package is one ``segment_spmm`` launch per layer over the graph's
destination-sorted CSR (``gcn.graph_csr``), weight 1 a live edge and 0 a
masked one, as in ``gcn.py``; the pooled readout is a ``scatter_sum`` over
the graph ids (the same kernel on the card, over one ``sum_plan`` a
forward).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.segment_spmm.ops import EdgeCSR, segment_spmm_csr
from repro_torch.models.gnn.common import layer_norm, mlp_apply, mlp_init, scatter_sum, sum_plan
from repro_torch.models.gnn.gcn import graph_csr


def init(cfg: GNNConfig, d_in: int, seed: int = 0, device: DeviceLike = None) -> Dict:
    """The JAX package's tree (``layers[i].{mlp, eps}``, ``readout.{w,
    b}``), ``w ~ N(0, 1/a)`` from a seeded ``torch.Generator`` on
    ``device`` (default ``"cuda"``)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    layers = []
    d_prev = d_in
    for _ in range(cfg.n_layers):
        layers.append({"mlp": mlp_init((d_prev, cfg.d_hidden, cfg.d_hidden), gen, device),
                       "eps": torch.zeros((), device=device)})
        d_prev = cfg.d_hidden
    d_cat = cfg.n_layers * cfg.d_hidden
    w_out = torch.randn((d_cat, cfg.n_classes), generator=gen, device=device) / math.sqrt(d_cat)
    return {"layers": layers,
            "readout": {"w": w_out, "b": torch.zeros((cfg.n_classes,), device=device)}}


def forward(params, batch: Dict, cfg: GNNConfig, n_graphs: int,
            node_level: bool = False, csr: Optional[EdgeCSR] = None) -> torch.Tensor:
    """Logits: ``(N, n_classes)`` node-level, else ``(n_graphs,
    n_classes)``; ``csr`` is the batch's ``gcn.graph_csr`` (built here when
    omitted)."""
    x = batch["node_feat"]
    emask, nmask = batch["edge_mask"], batch["node_mask"]
    gid = batch.get("graph_id")
    if csr is None:
        csr = graph_csr(batch)
    w = emask.to(torch.float32)[csr.order].contiguous()
    pooled = not node_level and gid is not None
    pool = sum_plan(gid.long(), n_graphs) if pooled else None   # one plan, every layer
    reps = []
    for lp in params["layers"]:
        agg = segment_spmm_csr(x, csr, w)
        x = mlp_apply(lp["mlp"], (1.0 + lp["eps"]) * x + agg)
        x = layer_norm(x) * nmask[:, None]
        if node_level:
            reps.append(x)
        elif pooled:
            reps.append(scatter_sum(x, gid, n_graphs, plan=pool))
        else:
            reps.append(x.sum(dim=0, keepdim=True))
    h = torch.cat(reps, dim=-1)
    return h @ params["readout"]["w"] + params["readout"]["b"]


def loss_fn(params, batch: Dict, cfg: GNNConfig, n_graphs: int,
            node_level: bool = False, csr: Optional[EdgeCSR] = None):
    """``(loss, metrics)``: mean cross-entropy and accuracy, over the
    node mask when node-level, over the graphs otherwise."""
    logits = forward(params, batch, cfg, n_graphs, node_level, csr).to(torch.float32)
    labels = batch["targets"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    ce = logz - gold
    correct = (logits.argmax(-1) == labels).to(torch.float32)
    if node_level:
        mask = batch["node_mask"].to(torch.float32)
        denom = torch.clamp(mask.sum(), min=1.0)
        loss = torch.sum(ce * mask) / denom
        acc = torch.sum(correct * mask) / denom
    else:
        loss = torch.mean(ce)
        acc = torch.mean(correct)
    return loss, {"loss": loss, "accuracy": acc}
