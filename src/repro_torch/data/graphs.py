"""Graph data pipeline: synthetic graph builders for the full-graph GNN
shape cells (numpy, bitwise equal to the JAX package's for the same seed
and scale).

The molecule cell and the ``minibatch_lg`` neighbour sampler come with the
GIN/NequIP/Equiformer slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import GNNConfig, ShapeSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.gnn import api as gnn_api

#: cells this builder takes (full graphs; the sampler's cells wait)
FULL_GRAPH_CELLS = ("full_graph_sm", "ogb_products")


def random_graph_batch(
    cfg: GNNConfig, shape: ShapeSpec, seed: int = 0, scale: float = 1.0
) -> Dict[str, np.ndarray]:
    """Concrete (host) arrays for one batch of a full-graph cell.

    ``scale`` < 1 shrinks node/edge counts for CPU smoke tests while keeping
    every structural property (padding, masks).
    """
    if shape.name not in FULL_GRAPH_CELLS:
        raise ValueError(f"shape cell {shape.name!r} is not ported yet "
                         f"(full-graph cells: {FULL_GRAPH_CELLS})")
    rng = np.random.default_rng(seed)
    d_feat = gnn_api.feature_dim(cfg, shape)

    N = shape.dim("n_nodes")
    E = shape.dim("n_edges")
    if scale < 1.0:
        N, E = max(64, int(N * scale)), max(256, int(E * scale))
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    if cfg.kind in ("nequip", "equiformer_v2"):
        node_feat = np.zeros((N, d_feat), np.float32)
        node_feat[np.arange(N), rng.integers(0, d_feat, N)] = 1.0
    else:
        node_feat = rng.normal(size=(N, d_feat)).astype(np.float32) * 0.1
    batch = {
        "node_feat": node_feat,
        "edge_src": src,
        "edge_dst": dst,
        "node_mask": np.ones(N, bool),
        "edge_mask": src != dst,
    }
    if gnn_api.needs_positions(cfg):
        batch["positions"] = rng.normal(size=(N, 3)).astype(np.float32)
    tshape, tdtype = gnn_api.target_spec(cfg, shape, N)
    batch["targets"] = _targets(rng, (N,), tdtype, cfg)
    return batch


def _targets(rng, shape, dtype, cfg: GNNConfig):
    if dtype == np.int32 or str(dtype).endswith("int32"):
        return rng.integers(0, cfg.n_classes, shape).astype(np.int32)
    return rng.normal(size=shape).astype(np.float32)


def batch_to_device(batch: Dict[str, np.ndarray],
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The batch's arrays as tensors on ``device`` (default ``"cuda"``)."""
    device = resolve_device(device)
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# CSR
# ---------------------------------------------------------------------------


@dataclass
class CSRGraph:
    n: int
    row_ptr: np.ndarray
    col: np.ndarray


def build_csr(n: int, m: int, seed: int = 0, skew: float = 1.0) -> CSRGraph:
    rng = np.random.default_rng(seed)
    u = rng.random(m)
    src = np.minimum((n * u ** (1 + skew)).astype(np.int64), n - 1)
    dst = rng.integers(0, n, m)
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    counts = np.bincount(src, minlength=n)
    row_ptr = np.concatenate([[0], np.cumsum(counts)])
    return CSRGraph(n, row_ptr.astype(np.int64), dst.astype(np.int32))
