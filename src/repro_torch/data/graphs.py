"""Graph data pipeline: synthetic graph builders for every GNN shape cell
and a real fanout neighbor sampler (GraphSAGE-style) for ``minibatch_lg``
(numpy, bitwise equal to the JAX package's for the same seed and scale:
the same ``np.random.Generator`` stream, the same arrays).

The sampler samples ``fanout`` neighbors per hop from a CSR adjacency (with
replacement when the degree exceeds the fanout, GraphSAGE semantics),
compacts the union of sampled vertices, and emits fixed-shape padded
arrays.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch.configs.base import GNNConfig, ShapeSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.gnn import api as gnn_api


# ---------------------------------------------------------------------------
# synthetic graphs per shape cell
# ---------------------------------------------------------------------------


def random_graph_batch(
    cfg: GNNConfig, shape: ShapeSpec, seed: int = 0, scale: float = 1.0
) -> Dict[str, np.ndarray]:
    """Concrete (host) arrays for one training batch of the given cell.

    ``scale`` < 1 shrinks node/edge counts for CPU smoke tests while keeping
    every structural property (padding, masks, graph ids).
    """
    rng = np.random.default_rng(seed)
    d_feat = gnn_api.feature_dim(cfg, shape)

    if shape.name == "molecule":
        G = shape.dim("batch")
        npg, epg = shape.dim("n_nodes"), shape.dim("n_edges")
        if scale < 1.0:
            G = max(2, int(G * scale))
        N, E = G * npg, G * epg
        node_feat = np.zeros((N, d_feat), np.float32)
        species = rng.integers(0, d_feat, N)
        node_feat[np.arange(N), species] = 1.0
        # random bonds within each molecule
        src = rng.integers(0, npg, E) + np.repeat(np.arange(G), epg) * npg
        dst = rng.integers(0, npg, E) + np.repeat(np.arange(G), epg) * npg
        batch = {
            "node_feat": node_feat,
            "edge_src": src.astype(np.int32),
            "edge_dst": dst.astype(np.int32),
            "node_mask": np.ones(N, bool),
            "edge_mask": (src != dst),
            "graph_id": np.repeat(np.arange(G), npg).astype(np.int32),
            "positions": rng.normal(size=(N, 3)).astype(np.float32),
        }
        tshape, tdtype = gnn_api.target_spec(cfg, shape, N)
        graph_level = tshape == (gnn_api.n_graphs_of(shape),)
        # graph-level target count must follow the (possibly scaled) G
        batch["targets"] = _targets(rng, (G,) if graph_level else (N,), tdtype, cfg)
        return batch

    if shape.name == "minibatch_lg":
        # the sampler produces this cell; here we build a scaled base graph
        base_n = max(2000, int(shape.dim("n_nodes") * scale))
        avg_deg = 16
        g = build_csr(base_n, base_n * avg_deg, seed)
        sampler = NeighborSampler(g, (shape.dim("fanout1"), shape.dim("fanout2")))
        seeds = rng.integers(0, base_n, max(32, int(shape.dim("batch_nodes") * scale)))
        sub = sampler.sample(seeds, rng)
        return subgraph_to_batch(sub, cfg, shape, d_feat, rng)

    # full-graph cells
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
# CSR + neighbor sampler
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


@dataclass
class SampledSubgraph:
    """Fixed-shape 2-hop sampled subgraph (padded)."""

    nodes: np.ndarray        # (N_sub,) original vertex ids (padded -1)
    edge_src: np.ndarray     # (E_sub,) local indices
    edge_dst: np.ndarray
    node_mask: np.ndarray
    edge_mask: np.ndarray
    n_seeds: int


class NeighborSampler:
    """GraphSAGE fanout sampler over CSR adjacency (with replacement)."""

    def __init__(self, g: CSRGraph, fanouts: Sequence[int]):
        self.g = g
        self.fanouts = tuple(fanouts)

    def max_nodes(self, n_seeds: int) -> int:
        total, cur = n_seeds, n_seeds
        for f in self.fanouts:
            cur = cur * f
            total += cur
        return total

    def sample(self, seeds: np.ndarray, rng: np.random.Generator) -> SampledSubgraph:
        g = self.g
        seeds = np.asarray(seeds, dtype=np.int64)
        frontier = seeds
        all_src, all_dst = [], []     # edges in ORIGINAL vertex ids (src=nbr, dst=center)
        layers = [seeds]
        for f in self.fanouts:
            deg = g.row_ptr[frontier + 1] - g.row_ptr[frontier]
            # with-replacement sampling: offsets uniform in [0, deg)
            offs = (rng.random((frontier.size, f)) * np.maximum(deg, 1)[:, None]).astype(np.int64)
            nbrs = g.col[np.minimum(g.row_ptr[frontier][:, None] + offs,
                                    len(g.col) - 1)]
            valid = (deg > 0)[:, None] & np.ones((1, f), bool)
            src = nbrs.reshape(-1)
            dst = np.repeat(frontier, f)
            mask = valid.reshape(-1)
            all_src.append(np.where(mask, src, -1))
            all_dst.append(np.where(mask, dst, -1))
            frontier = np.where(mask, src, 0).astype(np.int64)
            layers.append(frontier)
        src = np.concatenate(all_src)
        dst = np.concatenate(all_dst)

        # compact: union of vertices -> local ids (padded to max_nodes)
        uniq = np.unique(np.concatenate([l.reshape(-1) for l in layers]))
        uniq = uniq[uniq >= 0]
        cap = self.max_nodes(len(seeds))
        nodes = np.full(cap, -1, np.int64)
        nodes[: len(uniq)] = uniq
        remap = {int(v): i for i, v in enumerate(uniq)}
        emask = (src >= 0) & (dst >= 0)
        lsrc = np.array([remap.get(int(v), 0) for v in src], np.int32)
        ldst = np.array([remap.get(int(v), 0) for v in dst], np.int32)
        return SampledSubgraph(
            nodes=nodes,
            edge_src=np.where(emask, lsrc, 0).astype(np.int32),
            edge_dst=np.where(emask, ldst, 0).astype(np.int32),
            node_mask=nodes >= 0,
            edge_mask=emask,
            n_seeds=len(seeds),
        )


def subgraph_to_batch(sub: SampledSubgraph, cfg: GNNConfig, shape: ShapeSpec,
                      d_feat: int, rng) -> Dict[str, np.ndarray]:
    N = len(sub.nodes)
    if cfg.kind in ("nequip", "equiformer_v2"):
        node_feat = np.zeros((N, d_feat), np.float32)
        node_feat[np.arange(N), rng.integers(0, d_feat, N)] = 1.0
    else:
        node_feat = rng.normal(size=(N, d_feat)).astype(np.float32) * 0.1
    batch = {
        "node_feat": node_feat,
        "edge_src": sub.edge_src,
        "edge_dst": sub.edge_dst,
        "node_mask": sub.node_mask,
        "edge_mask": sub.edge_mask,
    }
    if gnn_api.needs_positions(cfg):
        batch["positions"] = rng.normal(size=(N, 3)).astype(np.float32)
    tshape, tdtype = gnn_api.target_spec(cfg, shape, N)
    batch["targets"] = _targets(rng, (N,), tdtype, cfg)
    return batch
