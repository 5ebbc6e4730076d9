"""Architecture and shape configuration dataclasses (the port's share).

The port carries the LM, GNN, DLRM and TAPER families; each configuration is a
frozen dataclass with the exact dimensions of the JAX package's
``configs/base.py``, plus a ``reduced()`` variant for CPU tests.  Shape
cells (``prefill_32k``, ``serve_p99``, ``ogb_products``, ...) are
``ShapeSpec`` entries.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell for an architecture."""

    name: str
    kind: str                 # "train" | "prefill" | "decode" | "serve" | ...
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


LM_SHAPES = (
    ShapeSpec("train_4k", "train", _dims(seq_len=4096, global_batch=256)),
    ShapeSpec("prefill_32k", "prefill", _dims(seq_len=32768, global_batch=32)),
    ShapeSpec("decode_32k", "decode", _dims(seq_len=32768, global_batch=128)),
    ShapeSpec("long_500k", "decode", _dims(seq_len=524288, global_batch=1)),
)

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
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert_ff: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    aux_coef: float = 1e-2


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    moe: Optional[MoEConfig] = None
    qk_norm: bool = False
    attn_bias: bool = False                 # qwen2.5-style QKV bias
    sliding_window: Optional[int] = None    # local-attention window
    global_every: int = 0                   # gemma3: every Nth layer is global
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    family: str = "lm"
    # long_500k applies only to archs with a sub-quadratic local-attention path
    supports_long_context: bool = False
    attention_chunk: int = 1024             # blocked-softmax KV chunk (decode)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def n_params(self) -> int:
        """Total parameter count (embeddings included)."""
        d, h, kv, dh, ff, V, L = (self.d_model, self.n_heads, self.n_kv_heads,
                                  self.d_head, self.d_ff, self.vocab, self.n_layers)
        attn = d * h * dh + 2 * d * kv * dh + h * dh * d
        if self.attn_bias:
            attn += (h + 2 * kv) * dh
        if self.moe:
            ffp = self.moe.n_experts * 3 * d * self.moe.d_expert_ff
            ffp += self.moe.n_shared * 3 * d * self.moe.d_expert_ff
            ffp += d * self.moe.n_experts  # router
        else:
            ffp = 3 * d * ff
        norms = 2 * d * L + d
        emb = V * d * (1 if self.tie_embeddings else 2)
        return L * (attn + ffp) + norms + emb

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only routed experts)."""
        if not self.moe:
            return self.n_params()
        d, L = self.d_model, self.n_layers
        dense = self.n_params() - L * (
            self.moe.n_experts * 3 * d * self.moe.d_expert_ff
        )
        active_ff = L * (self.moe.top_k * 3 * d * self.moe.d_expert_ff)
        return dense + active_ff

    def reduced(self) -> "LMConfig":
        """Tiny same-family config for CPU smoke tests, equal to the JAX
        package's.  Its d_head 16 is below the ``flash_attention`` kernel's
        head sizes (32, 64, 128, 256), so the port's ``forward`` rejects it:
        the port runs :meth:`reduced_for_port`."""
        kw = dataclasses.asdict(self)
        moe = None
        if self.moe:
            moe = MoEConfig(
                n_experts=min(self.moe.n_experts, 8),
                top_k=min(self.moe.top_k, 2),
                d_expert_ff=32,
                n_shared=min(self.moe.n_shared, 1),
            )
        kw.update(
            n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=max(1, 4 // max(self.q_per_kv, 1)),
            d_head=16, d_ff=128, vocab=256,
            sliding_window=16 if self.sliding_window else None,
            dtype="float32",
            attention_chunk=32,
        )
        kw["moe"] = moe
        return LMConfig(**kw)

    def reduced_for_port(self) -> "LMConfig":
        """:meth:`reduced` with d_head 32, the ``flash_attention`` kernel's
        smallest head size: the tiny config the port's ``forward`` runs."""
        return dataclasses.replace(self.reduced(), d_head=32)

    shapes = property(lambda self: LM_SHAPES)


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


@dataclass(frozen=True)
class TaperSystemConfig:
    """The paper's own technique as a cell: one extroversion-field refine
    step over a partitioned graph."""

    name: str = "taper_paper"
    n_vertices: int = 10_000_000
    avg_degree: float = 6.0
    n_labels: int = 12
    n_trie_nodes: int = 24
    trie_depth: int = 4
    k_partitions: int = 512
    family: str = "taper"

    def reduced(self) -> "TaperSystemConfig":
        return dataclasses.replace(self, n_vertices=2000, k_partitions=8)

    shapes = property(
        lambda self: (
            ShapeSpec("refine_step", "taper",
                      _dims(n_vertices=self.n_vertices,
                            n_edges=int(self.n_vertices * self.avg_degree))),
        )
    )


ArchConfig = (LMConfig, GNNConfig, DLRMConfig, TaperSystemConfig)
