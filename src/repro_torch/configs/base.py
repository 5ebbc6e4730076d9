"""Architecture and shape configuration dataclasses (the port's share).

The port carries the GNN and DLRM families, the ones its model slice runs;
each configuration is a frozen dataclass with the exact dimensions of the
JAX package's ``configs/base.py``, plus a ``reduced()`` variant for CPU
tests.  Shape cells (``serve_p99``, ``ogb_products``, ...) are
``ShapeSpec`` entries.  The language-model configurations come with the
transformer slice.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell for an architecture."""

    name: str
    kind: str                 # "train" | "serve" | "retrieval" | ...
    dims: Tuple[Tuple[str, int], ...] = ()

    def dim(self, key: str) -> int:
        for k, v in self.dims:
            if k == key:
                return v
        raise KeyError(key)

    def get(self, key: str, default=None):
        for k, v in self.dims:
            if k == key:
                return v
        return default


def _dims(**kwargs) -> Tuple[Tuple[str, int], ...]:
    return tuple(kwargs.items())


GNN_SHAPES = (
    ShapeSpec("full_graph_sm", "train",
              _dims(n_nodes=2708, n_edges=10556, d_feat=1433)),
    ShapeSpec("minibatch_lg", "train",
              _dims(n_nodes=232965, n_edges=114615892, batch_nodes=1024,
                    fanout1=15, fanout2=10, d_feat=602)),
    ShapeSpec("ogb_products", "train",
              _dims(n_nodes=2449029, n_edges=61859140, d_feat=100)),
    ShapeSpec("molecule", "train",
              _dims(n_nodes=30, n_edges=64, batch=128)),
)

DLRM_SHAPES = (
    ShapeSpec("train_batch", "train", _dims(batch=65536)),
    ShapeSpec("serve_p99", "serve", _dims(batch=512)),
    ShapeSpec("serve_bulk", "serve", _dims(batch=262144)),
    ShapeSpec("retrieval_cand", "retrieval", _dims(batch=1, n_candidates=1000000)),
)


# ---------------------------------------------------------------------------
# Architectures
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str                  # "gcn" | "gin" | "nequip" | "equiformer_v2"
    n_layers: int
    d_hidden: int
    # gcn/gin
    aggregator: str = "mean"
    norm: str = "sym"
    eps_learnable: bool = False
    # equivariant
    l_max: int = 0
    m_max: int = 0
    n_heads: int = 0
    n_rbf: int = 0
    cutoff: float = 5.0
    n_classes: int = 16
    dtype: str = "float32"
    family: str = "gnn"

    def reduced(self) -> "GNNConfig":
        kw = dataclasses.asdict(self)
        kw.update(
            n_layers=2, d_hidden=16,
            l_max=min(self.l_max, 2), m_max=min(self.m_max, 1) if self.m_max else 0,
            n_heads=min(self.n_heads, 2) if self.n_heads else 0,
            n_rbf=min(self.n_rbf, 4) if self.n_rbf else 0,
        )
        return GNNConfig(**kw)

    shapes = property(lambda self: GNN_SHAPES)


@dataclass(frozen=True)
class DLRMConfig:
    name: str
    n_dense: int
    n_sparse: int
    embed_dim: int
    bot_mlp: Tuple[int, ...]
    top_mlp: Tuple[int, ...]
    interaction: str = "dot"
    # per-table vocab sizes (criteo-like skew); len == n_sparse
    vocab_sizes: Tuple[int, ...] = ()
    multi_hot: int = 1          # ids per field (embedding-bag when > 1)
    dtype: str = "float32"
    family: str = "recsys"

    def total_rows(self) -> int:
        return sum(self.vocab_sizes)

    def n_params(self) -> int:
        p = self.total_rows() * self.embed_dim
        dims = (self.n_dense,) + self.bot_mlp
        p += sum(a * b + b for a, b in zip(dims, dims[1:]))
        n_feat = self.n_sparse + 1
        inter = n_feat * (n_feat - 1) // 2 if self.interaction == "dot" else 0
        dims = (inter + self.bot_mlp[-1],) + self.top_mlp
        p += sum(a * b + b for a, b in zip(dims, dims[1:]))
        return p

    def reduced(self) -> "DLRMConfig":
        return dataclasses.replace(
            self,
            embed_dim=8,
            bot_mlp=(16, 8),
            top_mlp=(16, 8, 1),
            vocab_sizes=tuple(min(v, 100) for v in self.vocab_sizes),
        )

    shapes = property(lambda self: DLRM_SHAPES)
