"""DLRM (Naumov et al., arXiv:1906.00091) — recsys kernel regime.

Bottom MLP over dense features, 26 embedding tables concatenated row-wise
into one ``(total_rows, d)`` matrix, dot-product feature interaction, top
MLP -> click logit.  Parameters are a plain dict of tensors in the JAX
package's layout: ``{"embedding", "bot": [{"w", "b"}...], "top": [...]}``.

The multi-hot lookup (``multi_hot > 1``) runs as the port's hand-written
``embedding_bag`` CUDA kernel; the single-hot lookup is a plain row gather
and the MLPs and the interaction are ``torch.matmul``/``bmm``, as the JAX
package leaves them to XLA.

TAPER integration: ``coaccess_graph`` builds the co-access graph of
embedding rows from a click log for TAPER to partition; ``query_span``
measures the shards-touched-per-request metric the placement optimises.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch.configs.base import DLRMConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs.graph import LabelledGraph
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.models.gnn.common import mlp_apply, mlp_init


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


def table_offsets(cfg: DLRMConfig) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(cfg.vocab_sizes)]).astype(np.int64)


def init(cfg: DLRMConfig, seed: int = 0, device: DeviceLike = None) -> Dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (default ``"cuda"``).  The table is scaled in place: at full width it is
    8.6 GB, and a second copy would not be freed before the first."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    emb = torch.randn((cfg.total_rows(), cfg.embed_dim), generator=gen,
                      device=device)
    emb.div_(math.sqrt(cfg.embed_dim))
    bot = mlp_init((cfg.n_dense,) + cfg.bot_mlp, gen, device)
    n_feat = cfg.n_sparse + 1
    inter = n_feat * (n_feat - 1) // 2 if cfg.interaction == "dot" else 0
    top = mlp_init((inter + cfg.bot_mlp[-1],) + cfg.top_mlp, gen, device)
    return {"embedding": emb, "bot": bot, "top": top}


def forward(params, batch: Dict, cfg: DLRMConfig) -> torch.Tensor:
    """batch: dense (B, n_dense) float; sparse (B, n_sparse[, multi_hot])
    int32 with *global* row ids (offsets already applied)."""
    dense, sparse = batch["dense"], batch["sparse"]
    B = dense.shape[0]
    x_bot = mlp_apply(params["bot"], dense, final_act=True)  # (B, d)
    if sparse.dim() == 2:
        emb = params["embedding"].index_select(0, sparse.reshape(-1).long())
    else:  # multi-hot: embedding bag per field
        B_, F, H = sparse.shape
        ids = sparse.reshape(B_ * F, H).to(torch.int32).contiguous()
        emb = embedding_bag(params["embedding"], ids)
    emb = emb.reshape(B, cfg.n_sparse, cfg.embed_dim)

    feats = torch.cat([x_bot[:, None, :], emb], dim=1)      # (B, F+1, d)
    if cfg.interaction == "dot":
        gram = torch.bmm(feats, feats.transpose(1, 2))
        iu = torch.triu_indices(feats.shape[1], feats.shape[1], offset=1,
                                device=feats.device)
        inter = gram[:, iu[0], iu[1]]                       # (B, F(F+1)/2)
        z = torch.cat([x_bot, inter], dim=-1)
    else:
        z = feats.reshape(B, -1)
    return mlp_apply(params["top"], z)[:, 0]                # logits (B,)


def serve_step(params, batch: Dict, cfg: DLRMConfig) -> torch.Tensor:
    return torch.sigmoid(forward(params, batch, cfg))


def retrieval_step(params, query: Dict, candidates: torch.Tensor,
                   top_k: int = 100):
    """Score one user against (n_cand, d) candidate embeddings: one matrix
    product and a top-k; returns ``(values, indices)``."""
    user = mlp_apply(params["bot"], query["dense"], final_act=True)  # (1, d)
    scores = (candidates @ user[0]).to(torch.float32)               # (n_cand,)
    return torch.topk(scores, top_k)


# ---------------------------------------------------------------------------
# TAPER integration: workload-aware row placement
# ---------------------------------------------------------------------------


def coaccess_graph(cfg: DLRMConfig, sparse_batches: Sequence[np.ndarray],
                   max_rows_per_field: int = 512, min_count: int = 2):
    """Build the row co-access graph from click-log batches.

    Vertices = (field, row) pairs (hot rows only, capped per field); labels =
    field ids; edges connect rows co-accessed by one request.  A request is a
    2-hop label path, so TAPER's trie sees the field-pair traversal pattern —
    the direct analogue of the paper's query workload."""
    # hot rows per field
    hot: Dict[int, np.ndarray] = {}
    for f in range(cfg.n_sparse):
        vals = np.concatenate([b[:, f].reshape(-1) for b in sparse_batches])
        uniq, cnt = np.unique(vals, return_counts=True)
        hot[f] = uniq[np.argsort(-cnt)][:max_rows_per_field]
    remap: Dict[int, int] = {}
    labels = []
    for f in range(cfg.n_sparse):
        for r in hot[f]:
            remap[int(r)] = len(labels)
            labels.append(f)
    edges = []
    for b in sparse_batches:
        ids = b if b.ndim == 2 else b.reshape(b.shape[0], -1)
        for row in ids[: 512]:
            present = [remap[int(v)] for v in row if int(v) in remap]
            edges.extend(
                (present[i], present[j])
                for i in range(len(present))
                for j in range(i + 1, len(present))
            )
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    # keep only systematically co-accessed pairs: a pair seen once is zipf
    # noise, a pair seen repeatedly is workload structure (the signal the
    # paper's traversal frequencies carry)
    n_v = len(labels)
    if len(edges):
        lo = np.minimum(edges[:, 0], edges[:, 1])
        hi = np.maximum(edges[:, 0], edges[:, 1])
        key = lo * n_v + hi
        uniq, counts = np.unique(key, return_counts=True)
        keep = uniq[counts >= min_count]
        edges = np.stack([keep // n_v, keep % n_v], axis=1)
    g = LabelledGraph.from_undirected_edges(
        n_v, np.asarray(labels, np.int32), edges,
        [f"F{f}" for f in range(cfg.n_sparse)],
    )
    inverse = np.full(len(labels), -1, np.int64)
    for orig, local in remap.items():
        inverse[local] = orig
    return g, inverse


def query_span(part_of_row: np.ndarray, sparse: np.ndarray, k: int) -> float:
    """Average number of shards touched per request (SWORD's 'query span')."""
    B = sparse.shape[0]
    ids = sparse.reshape(B, -1)
    parts = part_of_row[ids]
    span = np.array([len(np.unique(p)) for p in parts])
    return float(span.mean())
