"""Unified GNN entry points keyed by ``GNNConfig.kind`` and shape cell.

The port carries the SpMM regime's GCN so far; GIN, NequIP and
EquiformerV2 come with their slice.  Non-molecular shape cells feed the
equivariant models synthetic 3-D positions.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.configs.base import GNNConfig, ShapeSpec
from repro_torch.device import DeviceLike
from repro_torch.models.gnn import gcn
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


def init(cfg: GNNConfig, shape: ShapeSpec, seed: int = 0,
         device: DeviceLike = None) -> Dict:
    d_in = feature_dim(cfg, shape)
    if cfg.kind == "gcn":
        return gcn.init(cfg, d_in, seed=seed, device=device)
    raise ValueError(f"GNN kind {cfg.kind!r} is not ported yet")


def loss_fn(params, batch: Dict, cfg: GNNConfig, shape: ShapeSpec, csr=None):
    """The model's loss and metrics.  GCN has no pooled readout, so it
    trains node-level on every shape cell (the JAX package's choice);
    ``csr`` is the batch's ``gcn.graph_csr`` (built per call when
    omitted)."""
    if cfg.kind == "gcn":
        return gcn.loss_fn(params, batch, cfg, csr)
    raise ValueError(f"GNN kind {cfg.kind!r} is not ported yet")


def make_train_step(cfg: GNNConfig, shape: ShapeSpec, optimizer, csr=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, the update written into ``params`` and the optimizer state,
    as the LM's and DLRM's steps do; ``csr``, when given, is the (fixed)
    graph's CSR, reused by every step together with its cached
    transpose."""
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
