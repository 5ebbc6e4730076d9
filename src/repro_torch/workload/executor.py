"""Exact inter-partition-traversal (ipt) counting.

This is the evaluation oracle for partition quality (paper §6.1: "we measure
this experimentally by executing snapshots of query workloads over
partitioned graphs and counting the number of inter-partition traversals").

The executor counts (never materialises) every traversal a pattern-matching
engine would perform: a path instance ``v_1 ... v_j`` whose label string is
a prefix of some string in str(Q) causes one traversal per extension edge.
Counting is a DP over (vertex, trie-node) states — the integer twin of the
Visitor-Matrix probability DP — run in float64 numpy, so results are
deterministic and bitwise those of the JAX package's executor.

Because per-edge traversal counts depend only on (graph, query) — not on the
partitioning — they are computed once per graph version and cached; ``ipt``
for any partitioning is then a masked sum over cut edges.  Incremental
patching under graph mutations and path enumeration belong to the online
and serving slices of the port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.rpq import RPQ
from repro_torch.core.tpstry import TPSTry, TrieArrays
from repro_torch.graphs.graph import LabelledGraph


@dataclass
class _CountState:
    """Cached DP state for one (graph version, query)."""

    version: int
    trav: np.ndarray          # (m,) float64 per-edge traversal counts


def _count_full(g: LabelledGraph, depth1, steps, n_trie: int) -> Tuple[np.ndarray, np.ndarray]:
    """Full traversal-count DP over the whole edge list."""
    n, m = g.n, g.m
    cnt = np.zeros((n, n_trie), dtype=np.float64)
    for i, li in depth1:
        cnt[:, i] = (g.labels == li).astype(np.float64)
    trav = np.zeros(m, dtype=np.float64)
    src, dst = g.src, g.dst
    lab_dst = g.labels[dst]
    for c, par, lc in steps:
        contrib = cnt[src, par] * (lab_dst == lc)
        trav += contrib
        if m:
            cnt[:, c] += np.bincount(dst, weights=contrib, minlength=n)[:n]
    return trav, cnt


class QueryExecutor:
    """Caches per-query per-edge traversal counts for a graph (rebuilt when
    the graph's ``version`` moves)."""

    def __init__(self, g: LabelledGraph, star_max: int = 3, max_len: Optional[int] = None):
        self.g = g
        self.star_max = star_max
        self.max_len = max_len
        self._cache: Dict[str, _CountState] = {}

    def traversals(self, q: RPQ) -> np.ndarray:
        """(m,) float64 — number of times each directed edge is traversed
        when fully evaluating ``q`` over the graph."""
        qh = q.qhash
        state = self._cache.get(qh)
        if state is None or state.version != self.g.version:
            state = self._cache[qh] = self._build(q)
        return state.trav

    def _compile(self, q: RPQ) -> TrieArrays:
        return TPSTry.from_workload(
            [(q, 1.0)], max_len=self.max_len, star_max=self.star_max
        ).compile(self.g.label_names)

    def _build(self, q: RPQ) -> _CountState:
        trie = self._compile(q)
        depth1: List[Tuple[int, int]] = [
            (int(i), int(trie.label[i]))
            for i in range(trie.n_nodes)
            if trie.depth[i] == 1
        ]
        steps: List[Tuple[int, int, int]] = [
            (int(i), int(trie.parent[i]), int(trie.label[i]))
            for i in range(trie.n_nodes)
            if trie.depth[i] >= 2
        ]
        trav, _ = _count_full(self.g, depth1, steps, trie.n_nodes)
        return _CountState(self.g.version, trav)

    # -- metrics ---------------------------------------------------------------
    def ipt(self, q: RPQ, part: np.ndarray) -> float:
        """Inter-partition traversals for query ``q`` under ``part``."""
        trav = self.traversals(q)
        cut = part[self.g.src] != part[self.g.dst]
        return float(trav[cut].sum())

    def total_traversals(self, q: RPQ) -> float:
        return float(self.traversals(q).sum())

    def workload_ipt(
        self, workload: Sequence[Tuple[RPQ, float]], part: np.ndarray
    ) -> float:
        """Frequency-weighted expected ipt per query execution."""
        return sum(f * self.ipt(q, part) for q, f in workload)

