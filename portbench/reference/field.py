"""Plain reference of the extroversion field (paper §2.3, §3.2, §5.4).

Written from the definitions, in plain PyTorch over an edge list, in the
precision the caller asks for (float64 for the reference; a lower one for the
control).  It works everything out again from the raw arrays that the graph
maker produced: the symmetric, duplicate-free edge list in ``(src, dst)``
order, each edge's neighbour-label count, the local-edge mask of each
partitioning.

  alpha[v, c]  depth 1: p(c) / |{u : l(u) = l(c)}| where l(v) = l(c)
               depth d: sum over local edges (u, v) with l(v) = l(c) of
                        alpha[u, parent(c)] * cond_p(c) / cnt[u, l(v)]
  mass[u->w]   sum over trie nodes c of depth >= 2 with l(c) = l(w) of
               alpha[u, parent(c)] * cond_p(c) / cnt[u, l(w)]   (every edge)
  Pr(v)        sum of alpha[v, c] over non-leaf c with 1 <= depth(c) < depth
  extro_mass   sum of mass over the cut edges out of v
  extroversion extro_mass / Pr where Pr > 1e-30, else 0
  ext_to[v, q] sum of mass over the cut edges from v into part q
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from portbench.reference.trie import Trie

EPS = 1e-30


def build_graph(n: int, labels, edges, n_labels: int, device) -> Dict[str, torch.Tensor]:
    """The edge list and per-edge counts of the graph given by the maker's
    ``labels`` (n,) and undirected ``edges`` (e, 2): self loops dropped, both
    directions, duplicates merged, in ascending ``(src, dst)``."""
    device = torch.device(device)
    e = torch.as_tensor(np.asarray(edges), device=device).long()
    e = e[e[:, 0] != e[:, 1]]
    key = torch.unique(torch.cat([e[:, 0] * n + e[:, 1], e[:, 1] * n + e[:, 0]]))
    del e
    src, dst = key // n, key % n
    lab = torch.as_tensor(np.asarray(labels), device=device).long()
    dst_lab = lab[dst]
    flat = src * n_labels + dst_lab
    cnt = torch.bincount(flat, minlength=n * n_labels)
    return {"n": n, "src": src, "dst": dst, "lab": lab, "dst_lab": dst_lab,
            "cnt_e": cnt[flat], "lab_count": torch.bincount(lab, minlength=n_labels)}


def field(graph: Dict, trie: Trie, label_ids: Dict[str, int], part, k: int,
          dense_ext_to: bool, dtype: torch.dtype) -> Dict[str, Optional[torch.Tensor]]:
    """The field of partitioning ``part`` (n,) computed in ``dtype``; alpha's
    columns follow ``trie.paths``."""
    n, src, dst, lab, dst_lab = (graph[key] for key in ("n", "src", "dst", "lab", "dst_lab"))
    device = src.device
    part = torch.as_tensor(part, device=device).long()
    local = part[src] == part[dst]
    depth = trie.depth
    N, D = len(trie.paths), trie.max_depth
    node_lab = [label_ids[s[-1]] if s else -1 for s in trie.paths]
    alpha = torch.zeros((n, N), dtype=dtype, device=device)
    for c in range(N):
        if depth[c] == 1:
            prior = torch.tensor(trie.p[c], dtype=dtype, device=device) / \
                graph["lab_count"][node_lab[c]].clamp_min(1).to(dtype)
            alpha[:, c] = torch.where(lab == node_lab[c], prior, torch.zeros((), dtype=dtype,
                                                                              device=device))
    inv = 1.0 / graph["cnt_e"].clamp_min(1).to(dtype)
    mass = torch.zeros(src.shape[0], dtype=dtype, device=device)
    for d in range(2, D + 1):
        for c in (c for c in range(N) if depth[c] == d):
            cond = torch.tensor(trie.cond_p[c], dtype=dtype, device=device)
            msg = alpha[src, trie.parent[c]] * cond * inv * (dst_lab == node_lab[c]).to(dtype)
            mass += msg
            col = torch.zeros(n, dtype=dtype, device=device)
            col.index_add_(0, dst, msg * local.to(dtype))
            alpha[:, c] += col
            del msg, col
    pr = torch.zeros(n, dtype=dtype, device=device)
    for c in range(N):
        if 1 <= depth[c] < D and not trie.is_leaf[c]:
            pr += alpha[:, c]
    ext = mass * (~local).to(dtype)
    extro_mass = torch.zeros(n, dtype=dtype, device=device).index_add_(0, src, ext)
    extroversion = torch.where(pr > EPS, extro_mass / pr.clamp_min(EPS),
                               torch.zeros((), dtype=dtype, device=device))
    ext_to = None
    if dense_ext_to:
        ext_to = torch.zeros(n * k, dtype=dtype, device=device).index_add_(
            0, src * k + part[dst], ext).view(n, k)
    return {"alpha": alpha, "pr": pr, "edge_mass": mass, "extro_mass": extro_mass,
            "extroversion": extroversion, "ext_to": ext_to,
            "total_extroversion": extro_mass.sum()}
