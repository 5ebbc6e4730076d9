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
partitioning — they are computed once and cached; ``ipt`` for any
partitioning is then a masked sum over cut edges.  Under topology mutations
(``LabelledGraph.apply_mutations``) the cache is *delta-aware*: the DP state
(per-(vertex, trie-node) path counts plus per-edge traversal counts) is
patched across the graph's mutation log by re-deriving only the states and
edges whose (src-state, dst-label) contributions changed — the dirty set is
propagated depth by depth from the mutated endpoints, so a small mutation
batch costs O(affected neighbourhood), not a full DP over the graph.  The
patch is bitwise a rebuild.  Path enumeration (the serving request path)
belongs to the serving slice of the port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.rpq import RPQ
from repro_torch.core.tpstry import TPSTry, TrieArrays
from repro_torch.graphs.graph import AppliedMutation, LabelledGraph


@dataclass
class _CountState:
    """Cached DP state for one (graph version, query)."""

    version: int
    trav: np.ndarray          # (m,) float64 per-edge traversal counts
    cnt: np.ndarray           # (n, N) float64 per-(vertex, trie-node) counts
    depth1: List[Tuple[int, int]]   # (node, label) for depth-1 nodes
    steps: List[Tuple[int, int, int]]  # (node, parent, label), depth order


def _count_full(g: LabelledGraph, depth1, steps, n_trie: int) -> Tuple[np.ndarray, np.ndarray]:
    """Full traversal-count DP over the whole edge list (the rebuild path)."""
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
    """Caches per-query per-edge traversal counts for a graph.

    The cache follows the graph's mutation ``version``: a stale entry is
    patched incrementally from ``LabelledGraph.mutation_log`` when the log
    still covers the gap (and the graph is symmetric, so in-edges can be
    enumerated through ``reverse_edge_index``), and rebuilt from scratch
    otherwise.  Both paths produce bit-identical counts.
    """

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
        if state is not None and state.version == self.g.version:
            return state.trav
        if state is not None:
            patched = self._patch(state)
            if patched is not None:
                self._cache[qh] = patched
                return patched.trav
        self._cache[qh] = self._build(q)
        return self._cache[qh].trav

    def _compile(self, q: RPQ) -> TrieArrays:
        return TPSTry.from_workload(
            [(q, 1.0)], max_len=self.max_len, star_max=self.star_max
        ).compile(self.g.label_names)

    def _build(self, q: RPQ) -> _CountState:
        trie = self._compile(q)
        depth1 = [
            (int(i), int(trie.label[i]))
            for i in range(trie.n_nodes)
            if trie.depth[i] == 1
        ]
        steps = [
            (int(i), int(trie.parent[i]), int(trie.label[i]))
            for i in range(trie.n_nodes)
            if trie.depth[i] >= 2
        ]
        trav, cnt = _count_full(self.g, depth1, steps, trie.n_nodes)
        return _CountState(self.g.version, trav, cnt, depth1, steps)

    # -- incremental maintenance ----------------------------------------------
    def _covering_mutations(self, version: int) -> Optional[List[AppliedMutation]]:
        """The contiguous mutation-log chain taking ``version`` to the
        graph's current version, or None if the log no longer covers it.

        Log compaction composes old records into wider spans
        (``version_base -> version``), so the walk chains on spans rather
        than assuming one version per record; a snapshot that falls
        *strictly inside* a compacted span can no longer be patched."""
        entries = sorted(
            (e for e in self.g.mutation_log if e.version > version),
            key=lambda e: e.version)
        chain: List[AppliedMutation] = []
        cur = version
        for e in entries:
            if e.version_base == cur:
                chain.append(e)
                cur = e.version
            elif e.version_base > cur:
                return None  # gap: the log lost the span starting at cur
        if not chain or cur != self.g.version:
            return None
        return chain

    def _patch(self, state: _CountState) -> Optional[_CountState]:
        """Patch a stale DP state across the mutation gap, or None to force
        a rebuild.

        The patch never needs the intermediate graph snapshots: the per-edge
        index maps of the covered mutations compose into one old->new map,
        the structural endpoints union into one dirty seed set, and every
        affected quantity is then re-derived against the *final* arrays —
        per trie node, the (vertex, node) counts of affected destinations
        are recomputed from their in-edges (through ``reverse_edge_index``,
        in ascending edge order, matching ``np.bincount``'s accumulation
        order so the result is bit-identical to a full rebuild), and dirty
        destinations propagate to the next depth only when the recomputed
        value actually changed.
        """
        g = self.g
        entries = self._covering_mutations(state.version)
        if entries is None:
            return None
        if not g.is_symmetric():
            return None  # need total rev index to enumerate in-edges
        n_new, m_new = g.n, g.m
        n_before = entries[0].n_before

        # compose old->new edge index maps across the gap
        old2new = entries[0].old2new
        for e in entries[1:]:
            valid = old2new >= 0
            nxt = np.full(old2new.shape[0], -1, dtype=np.int64)
            nxt[valid] = e.old2new[old2new[valid]]
            old2new = nxt
        surv_old = np.nonzero(old2new >= 0)[0]
        surv_new = old2new[surv_old]
        # edges with no pre-gap ancestor are "added" w.r.t. the cached state
        is_mapped = np.zeros(m_new, dtype=bool)
        is_mapped[surv_new] = True
        added_pos = np.nonzero(~is_mapped)[0]

        # net re-labellings across the gap: earliest old, latest new; a
        # round-trip flip nets out (consumers re-derive vs final labels)
        rl_net: Dict[int, Tuple[int, int]] = {}
        for e in entries:
            for v, o, nw in zip(e.relabel_v.tolist(), e.relabel_old.tolist(),
                                e.relabel_new.tolist()):
                rl_net[v] = (rl_net[v][0], nw) if v in rl_net else (o, nw)
        rl_items = sorted(
            (v, o) for v, (o, nw) in rl_net.items()
            if o != nw and v < n_before)  # >= n_before: already conservative
        rl_v = np.asarray([v for v, _ in rl_items], dtype=np.int64)
        rl_old = np.asarray([o for _, o in rl_items], dtype=np.int64)

        # structural dirty endpoints (vertex ids are stable across versions)
        seed_dst: List[np.ndarray] = [g.dst[added_pos].astype(np.int64), rl_v]
        for e in entries:
            seed_dst.append(e.removed_dst.astype(np.int64))
        seed_dst_all = np.unique(np.concatenate(seed_dst))
        seed_dst_all = seed_dst_all[seed_dst_all < n_new]

        N = state.cnt.shape[1]
        trav = np.zeros(m_new, dtype=np.float64)
        trav[surv_new] = state.trav[surv_old]
        cnt = np.zeros((n_new, N), dtype=np.float64)
        cnt[:n_before] = state.cnt
        changed = np.zeros((n_new, N), dtype=bool)
        labels = g.labels
        for i, li in state.depth1:
            cnt[n_before:, i] = (labels[n_before:] == li).astype(np.float64)
        changed[n_before:, :] = True  # brand-new vertices: conservative

        rev = g.reverse_edge_index
        src, dst = g.src, g.dst
        touched: List[np.ndarray] = [added_pos]
        if rl_v.size:
            # depth-1 base case of every re-labelled vertex follows its
            # final label directly
            for i, li in state.depth1:
                newv = (labels[rl_v] == li).astype(np.float64)
                diff = newv != cnt[rl_v, i]
                changed[rl_v[diff], i] = True
                cnt[rl_v, i] = newv
            # deeper nodes gated on the *old* label go to zero now (the
            # vertex no longer matches); nodes gated on the new label are
            # re-derived by the seeded step loop below.  Marking `changed`
            # up front is safe: the loop only ever adds marks, and a zeroed
            # count is the vertex's final value for that node.
            for c, par, lc in state.steps:
                vs = rl_v[(rl_old == lc) & (labels[rl_v] != lc)]
                if vs.size:
                    stale = cnt[vs, c] != 0.0
                    changed[vs[stale], c] = True
                    cnt[vs, c] = 0.0
            # every in-edge of a re-labelled vertex carries a (src-state,
            # dst-label) contribution whose label test flipped
            touched.append(rev[g.edge_indices_of(rl_v)])
        for c, par, lc in state.steps:
            dirty_src = np.nonzero(changed[:, par])[0]
            eidx = g.edge_indices_of(dirty_src) if dirty_src.size else \
                np.empty(0, np.int64)
            if eidx.size:
                eidx = eidx[labels[dst[eidx]] == lc]
            if eidx.size:
                touched.append(eidx)
            aff_v = np.unique(np.concatenate([
                dst[eidx].astype(np.int64),
                seed_dst_all[labels[seed_dst_all] == lc],
            ]))
            if aff_v.size == 0:
                continue
            in_pos = rev[g.edge_indices_of(aff_v)]
            # per-destination in-edge sums, ascending edge order per bin
            # (identical accumulation order to the full DP's bincount)
            newvals = np.bincount(
                dst[in_pos], weights=cnt[src[in_pos], par], minlength=n_new
            )[aff_v] if in_pos.size else np.zeros(aff_v.size)
            upd = newvals != cnt[aff_v, c]
            changed[aff_v[upd], c] = True
            cnt[aff_v, c] = newvals

        # re-derive full traversal counts for every touched edge, summing
        # node contributions in the same (depth) order as the full DP
        eall = np.unique(np.concatenate(touched))
        if eall.size:
            t = np.zeros(eall.size, dtype=np.float64)
            s_e, lab_e = src[eall], labels[dst[eall]]
            for c, par, lc in state.steps:
                t += cnt[s_e, par] * (lab_e == lc)
            trav[eall] = t
        return _CountState(g.version, trav, cnt, state.depth1, state.steps)

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

    def collect(self) -> Dict[str, int]:
        """Metrics-registry collector: traversal-count cache occupancy
        (the enumeration counters arrive with the serving slice)."""
        return {"count_cache_size": len(self._cache)}


def ipt_of_partition(
    g: LabelledGraph,
    workload: Sequence[Tuple[RPQ, float]],
    part: np.ndarray,
    executor: Optional[QueryExecutor] = None,
) -> float:
    """Convenience wrapper: expected ipt of a partitioning under a workload."""
    ex = executor or QueryExecutor(g)
    return ex.workload_ipt(workload, part)
