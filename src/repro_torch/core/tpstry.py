"""TPSTry — the Traversal Pattern Summary Trie (paper §4).

Encodes the label strings expanded from every RPQ in the workload as a prefix
trie.  Each node carries the set of queries that can traverse a path with that
label prefix, and a probability ``p(n)`` (paper §4.1):

    p(n) = sum_Q Pr(root -> ... -> n | Q) * Pr(Q)

where, *within* a query, the next-label distribution at a prefix is uniform
over the distinct next symbols the query admits at that prefix (paper §4.1's
worked example: "initially Q2 can match both a and c, with equal
probability").

The trie grows with ``|L_V|^t`` (not ``|V|^t``) — it is the *intensional*
representation that makes TAPER tractable.

``TrieArrays`` is the array compilation consumed by the vectorised
Visitor-Matrix DP (repro_torch.core.visitor): static topology (numpy int
arrays with a hashable signature that keys the field's caches) + dynamic
probabilities (updated as workload frequencies drift).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.rpq import RPQ
from repro_torch.utils import get_logger

log = get_logger("core.tpstry")


@dataclass
class _Node:
    node_id: int
    symbol: str            # label symbol on the incoming edge ("" for root)
    parent: int            # -1 for root
    depth: int
    children: Dict[str, int] = field(default_factory=dict)
    queries: set = field(default_factory=set)   # qhashes whose strings pass here
    p: float = 0.0


class TPSTry:
    """Mutable trie multimap + query frequency table (paper §5.3)."""

    def __init__(self, max_len: int = 5, star_max: int = 3):
        self.max_len = max_len
        self.star_max = star_max
        self.nodes: List[_Node] = [_Node(0, "", -1, 0)]
        self._queries: Dict[str, RPQ] = {}          # qhash -> expression
        self._freqs: Dict[str, float] = {}          # qhash -> relative frequency
        self._strings: Dict[str, FrozenSet[Tuple[str, ...]]] = {}
        self._snapshots: Dict[Optional[str], np.ndarray] = {}

    # -- construction -------------------------------------------------------
    @classmethod
    def from_workload(
        cls,
        workload: Sequence[Tuple[RPQ, float]],
        max_len: Optional[int] = None,
        star_max: int = 3,
    ) -> "TPSTry":
        if max_len is None:
            max_len = 1
            for q, _ in workload:
                longest = max((len(s) for s in q.strings(32, star_max)), default=1)
                max_len = max(max_len, longest)
        trie = cls(max_len=max_len, star_max=star_max)
        for q, f in workload:
            trie.add_query(q)
        trie.set_frequencies({q.qhash: f for q, f in workload})
        return trie

    def add_query(self, q: RPQ) -> None:
        """Standard trie insertion of str(Q); label every prefix node (§4)."""
        qh = q.qhash
        if qh in self._queries:
            return
        strings = q.strings(self.max_len, self.star_max)
        if not strings:
            raise ValueError(f"query {q.to_text()} expands to no strings <= {self.max_len}")
        self._queries[qh] = q
        self._strings[qh] = strings
        for s in strings:
            cur = 0
            for sym in s:
                node = self.nodes[cur]
                nxt = node.children.get(sym)
                if nxt is None:
                    nxt = len(self.nodes)
                    self.nodes.append(_Node(nxt, sym, cur, node.depth + 1))
                    node.children[sym] = nxt
                self.nodes[nxt].queries.add(qh)
                cur = nxt
        self._freqs.setdefault(qh, 0.0)

    def set_frequencies(self, freqs: Dict[str, float]) -> None:
        """Update relative frequencies; drop queries at frequency 0 (§4:
        'if an expression is not seen ... its label is removed from nodes in
        the trie; any node without any query labels is also removed')."""
        total = sum(max(f, 0.0) for f in freqs.values())
        norm = {qh: max(f, 0.0) / total for qh, f in freqs.items()} if total > 0 else {}
        dead = [qh for qh in self._queries if norm.get(qh, 0.0) <= 0.0]
        for qh in dead:
            self._remove_query(qh)
        self._freqs = {qh: norm[qh] for qh in self._queries}
        self._recompute_probabilities()

    def _remove_query(self, qh: str) -> None:
        self._queries.pop(qh, None)
        self._strings.pop(qh, None)
        self._freqs.pop(qh, None)
        for node in self.nodes:
            node.queries.discard(qh)
        self._prune_unlabelled()

    def _prune_unlabelled(self) -> None:
        keep = [True] * len(self.nodes)
        for node in self.nodes[1:]:
            if not node.queries:
                keep[node.node_id] = False
        if all(keep):
            return
        remap = {}
        new_nodes: List[_Node] = []
        for node in self.nodes:
            if keep[node.node_id]:
                remap[node.node_id] = len(new_nodes)
                new_nodes.append(node)
        for node in new_nodes:
            node.node_id = remap[node.node_id]
            node.parent = remap.get(node.parent, -1) if node.parent >= 0 else -1
            node.children = {
                sym: remap[cid] for sym, cid in node.children.items() if cid in remap
            }
        self.nodes = new_nodes

    # -- probabilities (§4.1) -------------------------------------------------
    def _recompute_probabilities(self) -> None:
        for node in self.nodes:
            node.p = 0.0
        self.nodes[0].p = 1.0
        for qh, fq in self._freqs.items():
            if fq <= 0.0:
                continue
            # BFS over nodes labelled with this query; per-query conditional
            # is uniform over the distinct next symbols the query admits.
            pr_given_q = {0: 1.0}
            frontier = [0]
            while frontier:
                nxt_frontier = []
                for nid in frontier:
                    node = self.nodes[nid]
                    kids = [
                        cid for cid in node.children.values()
                        if qh in self.nodes[cid].queries
                    ]
                    if not kids:
                        continue
                    share = pr_given_q[nid] / len(kids)
                    for cid in kids:
                        pr_given_q[cid] = pr_given_q.get(cid, 0.0) + share
                        nxt_frontier.append(cid)
                frontier = nxt_frontier
            for nid, pr in pr_given_q.items():
                if nid != 0:
                    self.nodes[nid].p += fq * pr

    # -- queries --------------------------------------------------------------
    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    @property
    def max_depth(self) -> int:
        return max((n.depth for n in self.nodes), default=0)

    def node_by_path(self, symbols: Sequence[str]) -> Optional[_Node]:
        cur = 0
        for sym in symbols:
            cur = self.nodes[cur].children.get(sym)
            if cur is None:
                return None
            cur = int(cur)
        return self.nodes[cur]

    def prob_of_path(self, symbols: Sequence[str]) -> float:
        node = self.node_by_path(symbols)
        return 0.0 if node is None else node.p

    def frequencies(self) -> Dict[str, float]:
        return dict(self._freqs)

    # -- snapshotting (§4.2: lazy VM re-evaluation between iterations) --------
    def snapshot(self, key: Optional[str] = None) -> None:
        """Record the current node probabilities.  ``key`` namespaces the
        snapshot so independent observers (e.g. each Taper instance, plus an
        online driver polling for drift) can track changes without clobbering
        one another; ``None`` is the default shared slot."""
        self._snapshots[key] = np.array([n.p for n in self.nodes],
                                        dtype=np.float64)

    def drop_snapshot(self, key: Optional[str] = None) -> None:
        """Discard the snapshot stored under ``key`` (used by observers —
        e.g. a Taper being garbage-collected — so per-observer slots don't
        accumulate on a long-lived trie)."""
        self._snapshots.pop(key, None)

    def changed_since_snapshot(
        self, atol: float = 1e-12, key: Optional[str] = None
    ) -> np.ndarray:
        """Boolean mask over node ids whose probability changed since the
        last snapshot under ``key`` (nodes added since count as changed)."""
        cur = np.array([n.p for n in self.nodes], dtype=np.float64)
        prev = self._snapshots.get(key)
        if prev is None:
            return np.ones(len(cur), dtype=bool)
        if len(prev) < len(cur):
            prev = np.concatenate([prev, np.full(len(cur) - len(prev), np.nan)])
        return ~np.isclose(cur, prev[: len(cur)], atol=atol, equal_nan=False)

    # -- compilation ------------------------------------------------------------
    def compile(self, label_names: Sequence[str]) -> "TrieArrays":
        """Compile to arrays against a graph's label vocabulary.

        Trie symbols missing from the vocabulary make their subtree
        unreachable on that graph; they are dropped with a warning.
        """
        name_to_id = {s: i for i, s in enumerate(label_names)}
        keep: List[int] = []
        old_to_new: Dict[int, int] = {}
        for node in self.nodes:  # BFS order guaranteed: parents precede children
            if node.node_id == 0:
                old_to_new[0] = 0
                keep.append(0)
                continue
            if node.symbol not in name_to_id:
                log.warning("trie symbol %r not in graph labels; dropped", node.symbol)
                continue
            if node.parent not in old_to_new:
                continue  # ancestor dropped
            old_to_new[node.node_id] = len(keep)
            keep.append(node.node_id)

        order = sorted(keep, key=lambda nid: (self.nodes[nid].depth, nid))
        old_to_new = {nid: i for i, nid in enumerate(order)}
        N = len(order)
        parent = np.full(N, -1, dtype=np.int32)
        lab = np.full(N, -1, dtype=np.int32)
        depth = np.zeros(N, dtype=np.int32)
        p = np.zeros(N, dtype=np.float32)
        child_index = np.full((N, len(label_names)), -1, dtype=np.int32)
        for nid in order:
            node = self.nodes[nid]
            i = old_to_new[nid]
            depth[i] = node.depth
            p[i] = node.p
            if nid != 0:
                parent[i] = old_to_new[node.parent]
                lab[i] = name_to_id[node.symbol]
            for sym, cid in node.children.items():
                if cid in old_to_new:
                    child_index[i, name_to_id[sym]] = old_to_new[cid]
        is_leaf = (child_index < 0).all(axis=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            cond_p = np.where(
                parent >= 0, p / np.maximum(p[np.maximum(parent, 0)], 1e-30), 0.0
            ).astype(np.float32)
        return TrieArrays(
            parent=parent,
            label=lab,
            depth=depth,
            p=p,
            cond_p=cond_p,
            child_index=child_index,
            is_leaf=is_leaf,
            n_labels=len(label_names),
        )


def synthetic_trie(n_labels: int = 12, depth: int = 4, branching: int = 2,
                   n_first: int = 3, seed: int = 0) -> "TrieArrays":
    """Deterministic synthetic TrieArrays for dry-runs/benchmarks at
    production scale (a plausible workload summary without real queries).
    The arrays follow from the shape arguments alone; ``seed`` is kept for
    the reference's signature."""
    parent, label, depth_arr, p = [-1], [-1], [0], [1.0]
    frontier = []
    for i in range(min(n_first, n_labels)):
        parent.append(0)
        label.append(i)
        depth_arr.append(1)
        p.append(1.0 / n_first)
        frontier.append(len(parent) - 1)
    for d in range(2, depth + 1):
        nxt = []
        for node in frontier:
            used = set()
            for b in range(branching):
                lab = int((label[node] + 1 + b * 3 + d) % n_labels)
                if lab in used:
                    continue
                used.add(lab)
                parent.append(node)
                label.append(lab)
                depth_arr.append(d)
                p.append(p[node] * (0.5 if branching > 1 else 0.9) * 0.9)
                nxt.append(len(parent) - 1)
        frontier = nxt
    N = len(parent)
    parent = np.asarray(parent, np.int32)
    label = np.asarray(label, np.int32)
    depth_arr = np.asarray(depth_arr, np.int32)
    p = np.asarray(p, np.float32)
    child_index = np.full((N, n_labels), -1, np.int32)
    for i in range(1, N):
        child_index[parent[i], label[i]] = i
    is_leaf = (child_index < 0).all(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        cond_p = np.where(parent >= 0,
                          p / np.maximum(p[np.maximum(parent, 0)], 1e-30),
                          0.0).astype(np.float32)
    return TrieArrays(parent=parent, label=label, depth=depth_arr, p=p,
                      cond_p=cond_p, child_index=child_index,
                      is_leaf=is_leaf, n_labels=n_labels)


@dataclass(frozen=True)
class TrieArrays:
    """Array form of the TPSTry.  Topology arrays are numpy (static — they key
    the field's caches); probabilities (`p`, `cond_p`) are runtime inputs."""

    parent: np.ndarray       # (N,) int32, -1 for root
    label: np.ndarray        # (N,) int32 label id, -1 for root
    depth: np.ndarray        # (N,) int32
    p: np.ndarray            # (N,) float32
    cond_p: np.ndarray       # (N,) float32  p(n)/p(parent(n))
    child_index: np.ndarray  # (N, L) int32, -1 = no child
    is_leaf: np.ndarray      # (N,) bool
    n_labels: int

    @property
    def n_nodes(self) -> int:
        return int(self.parent.shape[0])

    @property
    def max_depth(self) -> int:
        return int(self.depth.max()) if self.n_nodes else 0

    def topology_signature(self) -> Tuple:
        """Hashable topology key (probabilities excluded) for cache keys."""
        return (
            self.parent.tobytes(),
            self.label.tobytes(),
            self.is_leaf.tobytes(),
            self.n_labels,
        )
