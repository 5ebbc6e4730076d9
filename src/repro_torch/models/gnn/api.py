"""Unified GNN entry points keyed by ``GNNConfig.kind`` and shape cell.

The four GNNs fall in three kernel regimes: SpMM (gcn, gin), CG tensor
product (nequip), SO(2)/eSCN (equiformer_v2); every one aggregates through
the ``segment_spmm`` kernel on the card.  Non-molecular shape cells feed
the equivariant models synthetic 3-D positions.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.configs.base import GNNConfig, ShapeSpec
from repro_torch.device import DeviceLike
from repro_torch.models.gnn import common, equiformer, gcn, gin, nequip
from repro_torch.utils import tree

N_SPECIES = 16  # synthetic atomic-species vocabulary for equivariant models


def feature_dim(cfg: GNNConfig, shape: ShapeSpec) -> int:
    if cfg.kind in ("nequip", "equiformer_v2"):
        return N_SPECIES
    return shape.get("d_feat", N_SPECIES)


def is_graph_level(cfg: GNNConfig, shape: ShapeSpec) -> bool:
    return shape.name == "molecule"


def n_graphs_of(shape: ShapeSpec) -> int:
    return shape.get("batch", 1)


_KINDS = {"gcn": gcn, "gin": gin, "nequip": nequip, "equiformer_v2": equiformer}


def _model(cfg: GNNConfig):
    if cfg.kind not in _KINDS:
        raise ValueError(f"unknown GNN kind {cfg.kind!r}")
    return _KINDS[cfg.kind]


def init(cfg: GNNConfig, shape: ShapeSpec, seed: int = 0,
         device: DeviceLike = None) -> Dict:
    """Seeded parameters of ``cfg``'s model for ``shape`` on ``device``
    (default ``"cuda"``), in the JAX package's tree."""
    return _model(cfg).init(cfg, feature_dim(cfg, shape), seed=seed, device=device)


def param_logical_axes(cfg: GNNConfig, params: Dict) -> Dict:
    """The logical axis names of each dimension of ``params`` (:func:`init`'s
    tree; the JAX package's ``init`` returns them beside the parameters):
    GCN splits its features over ``feat_model``, the other models replicate
    every parameter."""
    if cfg.kind == "gcn":
        return {"layers": [{"w": (None, "feat_model"), "b": ("feat_model",)}
                           for _ in params["layers"]]}
    return tree.map_leaves(lambda t: (None,) * t.dim(), params)


def _n_graphs(cfg: GNNConfig, batch: Dict, shape: ShapeSpec) -> int:
    """The pooled-graph count the model's forward takes: it follows the
    batch on the molecule cell (scaled smoke batches)."""
    if not is_graph_level(cfg, shape):
        return 1 if needs_positions(cfg) else n_graphs_of(shape)
    return batch["targets"].shape[0]


def batch_plan(cfg: GNNConfig, batch: Dict, shape: ShapeSpec):
    """What the model's segment sums over ``batch`` launch over, built once
    for a fixed batch and passed to :func:`loss_fn` as ``csr``: the graph's
    ``gcn.graph_csr`` for GCN and GIN, ``common.message_plans`` for the
    equivariant models.  Each build is a stable sort and a host
    synchronisation, and the backward's transposed CSRs are cached on it."""
    if not needs_positions(cfg):
        return gcn.graph_csr(batch)
    _, _, emask = common.edge_geometry(batch, cfg.cutoff)
    return common.message_plans(batch, emask, _n_graphs(cfg, batch, shape))


def loss_fn(params, batch: Dict, cfg: GNNConfig, shape: ShapeSpec, csr=None):
    """The model's loss and metrics.  GCN has no pooled readout, so it
    trains node-level on every shape cell (the JAX package's choice); GIN
    pools on the molecule cell; the equivariant models regress per-graph
    energies there and per-node scalars elsewhere.  ``csr`` is the batch's
    :func:`batch_plan` (built in each forward when omitted)."""
    graph_level = is_graph_level(cfg, shape)
    G = _n_graphs(cfg, batch, shape)
    if cfg.kind == "gcn":
        return gcn.loss_fn(params, batch, cfg, csr)
    if cfg.kind == "gin":
        return gin.loss_fn(params, batch, cfg, G, node_level=not graph_level, csr=csr)
    return _model(cfg).loss_fn(params, batch, cfg, G, csr)


def make_train_step(cfg: GNNConfig, shape: ShapeSpec, optimizer, csr=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, the update written into ``params`` and the optimizer state,
    as the LM's and DLRM's steps do; ``csr``, when given, is the (fixed)
    batch's :func:`batch_plan`, reused by every step together with its
    cached transposes."""
    def train_step(params, opt_state, batch):
        (loss, metrics), grads = tree.value_and_grad(
            lambda p: loss_fn(p, batch, cfg, shape, csr), params)
        params, opt_state = optimizer.update(params, grads, opt_state, inplace=True)
        return params, opt_state, metrics

    return train_step


def needs_positions(cfg: GNNConfig) -> bool:
    return cfg.kind in ("nequip", "equiformer_v2")


def target_spec(cfg: GNNConfig, shape: ShapeSpec, n_nodes: int):
    """(shape, dtype) of the targets array for this cell.

    GCN has no pooled readout, so it always trains node-level; GIN pools on
    molecule batches; equivariant models regress per-graph energies on
    molecule batches and per-node scalars elsewhere."""
    if cfg.kind in ("nequip", "equiformer_v2"):
        if is_graph_level(cfg, shape):
            return (n_graphs_of(shape),), np.float32
        return (n_nodes,), np.float32
    if cfg.kind == "gin" and is_graph_level(cfg, shape):
        return (n_graphs_of(shape),), np.int32
    return (n_nodes,), np.int32
