"""Initial graph partitioners.

TAPER *enhances* an existing partitioning (paper §1.1); it never computes one
from scratch.  We provide the two starting points the paper evaluates —
hash and (unweighted) Metis:

* ``hash_partition`` — the cheap baseline (paper §1: "grouping vertices by
  some hash of their ids").
* ``metis_like_partition`` — an in-repo multilevel min-edge-cut partitioner
  (heavy-edge-matching coarsening, greedy region-growing initialisation,
  boundary FM refinement at every level).  Stands in for the Metis binary;
  same objective, no external dependency.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from repro_torch.graphs.graph import LabelledGraph
from repro_torch.utils import get_logger

log = get_logger("graphs.partition")


# ---------------------------------------------------------------------------
# Hash
# ---------------------------------------------------------------------------


def hash_partition(n: int, k: int, seed: int = 0) -> np.ndarray:
    """Pseudo-random balanced assignment by a mixed hash of the vertex id."""
    ids = np.arange(n, dtype=np.uint64)
    mix = (seed * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ids + np.uint64(mix)
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return (x % np.uint64(k)).astype(np.int32)


# ---------------------------------------------------------------------------
# Multilevel min edge-cut ("metis-like")
# ---------------------------------------------------------------------------


@dataclass
class _CoarseGraph:
    n: int
    src: np.ndarray       # directed symmetric
    dst: np.ndarray
    ewgt: np.ndarray      # per directed edge
    vwgt: np.ndarray      # per vertex
    row_ptr: np.ndarray
    fine_to_coarse: Optional[np.ndarray] = None  # mapping from the finer level


def _build_csr(n: int, src: np.ndarray, dst: np.ndarray, ewgt: np.ndarray) -> _CoarseGraph:
    order = np.lexsort((dst, src))
    src, dst, ewgt = src[order], dst[order], ewgt[order]
    # merge parallel edges
    if len(src):
        key = src.astype(np.int64) * n + dst
        uniq, inv = np.unique(key, return_inverse=True)
        w = np.zeros(len(uniq), dtype=np.float64)
        np.add.at(w, inv, ewgt)
        src = (uniq // n).astype(np.int32)
        dst = (uniq % n).astype(np.int32)
        ewgt = w
    counts = np.bincount(src, minlength=n)
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return _CoarseGraph(n, src, dst, ewgt, np.ones(n), row_ptr)


def _heavy_edge_matching(cg: _CoarseGraph, rng: np.random.Generator) -> Tuple[_CoarseGraph, np.ndarray]:
    """One coarsening level; returns (coarser graph, fine->coarse map)."""
    match = -np.ones(cg.n, dtype=np.int64)
    order = rng.permutation(cg.n)
    for v in order:
        if match[v] >= 0:
            continue
        lo, hi = cg.row_ptr[v], cg.row_ptr[v + 1]
        nbrs, w = cg.dst[lo:hi], cg.ewgt[lo:hi]
        free = match[nbrs] < 0
        cand, cw = nbrs[free], w[free]
        cand_mask = cand != v
        cand, cw = cand[cand_mask], cw[cand_mask]
        if cand.size:
            u = int(cand[np.argmax(cw)])
            match[v], match[u] = u, v
        else:
            match[v] = v
    # assign coarse ids
    coarse_id = -np.ones(cg.n, dtype=np.int64)
    nxt = 0
    for v in range(cg.n):
        if coarse_id[v] < 0:
            coarse_id[v] = nxt
            u = match[v]
            if u != v and coarse_id[u] < 0:
                coarse_id[u] = nxt
            nxt += 1
    csrc = coarse_id[cg.src].astype(np.int32)
    cdst = coarse_id[cg.dst].astype(np.int32)
    keep = csrc != cdst
    out = _build_csr(nxt, csrc[keep], cdst[keep], cg.ewgt[keep])
    vwgt = np.zeros(nxt)
    np.add.at(vwgt, coarse_id, cg.vwgt)
    out.vwgt = vwgt
    out.fine_to_coarse = coarse_id
    return out, coarse_id


def _region_grow_init(cg: _CoarseGraph, k: int, rng: np.random.Generator) -> np.ndarray:
    """BFS-order chunking: balanced by construction, locality from BFS."""
    visited = np.zeros(cg.n, dtype=bool)
    order: list = []
    perm = rng.permutation(cg.n)
    for s in perm:
        if visited[s]:
            continue
        queue = [int(s)]
        visited[s] = True
        while queue:
            v = queue.pop(0)
            order.append(v)
            lo, hi = cg.row_ptr[v], cg.row_ptr[v + 1]
            for u in cg.dst[lo:hi]:
                if not visited[u]:
                    visited[u] = True
                    queue.append(int(u))
    order = np.asarray(order)
    cum = np.cumsum(cg.vwgt[order])
    total = cum[-1]
    part = np.empty(cg.n, dtype=np.int32)
    part[order] = np.minimum((cum * k / (total + 1e-9)).astype(np.int32), k - 1)
    return part


def _fm_refine(
    cg: _CoarseGraph,
    part: np.ndarray,
    k: int,
    epsilon: float,
    passes: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """Boundary FM-style greedy refinement on weighted edge-cut."""
    part = part.copy()
    sizes = np.zeros(k)
    np.add.at(sizes, part, cg.vwgt)
    max_size = (1.0 + epsilon) * cg.vwgt.sum() / k

    def _rebalance():
        """Force oversized partitions under max_size (min-loss moves)."""
        for p in np.argsort(-sizes):
            while sizes[p] > max_size:
                members = np.nonzero(part == p)[0]
                w_to = np.zeros((members.size, k))
                for i, v in enumerate(members):
                    lo, hi = cg.row_ptr[v], cg.row_ptr[v + 1]
                    np.add.at(w_to[i], part[cg.dst[lo:hi]], cg.ewgt[lo:hi])
                loss = w_to[:, p] - w_to.max(axis=1)
                for i in np.argsort(loss):
                    v = members[i]
                    dests = np.argsort(-w_to[i])
                    dests = [d for d in dests if d != p and sizes[d] + cg.vwgt[v] <= max_size]
                    if not dests:
                        continue
                    d = int(dests[0])
                    sizes[p] -= cg.vwgt[v]
                    sizes[d] += cg.vwgt[v]
                    part[v] = d
                    if sizes[p] <= max_size:
                        break
                else:
                    return  # cannot rebalance further

    _rebalance()
    for _ in range(passes):
        moved = 0
        # external/internal weighted degrees per vertex (recomputed per pass)
        w_to = np.zeros((cg.n, k))
        np.add.at(w_to, (cg.src, part[cg.dst]), cg.ewgt)
        internal = w_to[np.arange(cg.n), part]
        best_gain = w_to.max(axis=1) - internal
        boundary = np.nonzero(best_gain > 0)[0]
        order = boundary[np.argsort(-best_gain[boundary])]
        for v in order:
            p_old = part[v]
            gains = w_to[v] - w_to[v, p_old]
            gains[p_old] = -np.inf
            cand = np.argsort(-gains)
            for p_new in cand:
                if gains[p_new] <= 0:
                    break
                if sizes[p_new] + cg.vwgt[v] <= max_size:
                    # apply and update neighbour tallies
                    lo, hi = cg.row_ptr[v], cg.row_ptr[v + 1]
                    nbrs, w = cg.dst[lo:hi], cg.ewgt[lo:hi]
                    np.subtract.at(w_to, (nbrs, np.full(nbrs.size, p_old)), w)
                    np.add.at(w_to, (nbrs, np.full(nbrs.size, int(p_new))), w)
                    sizes[p_old] -= cg.vwgt[v]
                    sizes[p_new] += cg.vwgt[v]
                    part[v] = int(p_new)
                    moved += 1
                    break
        if moved == 0:
            break
    return part


def metis_like_partition(
    g: LabelledGraph,
    k: int,
    seed: int = 0,
    epsilon: float = 0.05,
    coarsen_to: Optional[int] = None,
    refine_passes: int = 4,
    restarts: int = 2,
) -> np.ndarray:
    """Multilevel k-way min-edge-cut partitioning (unweighted input edges).

    Matches the paper's use of Metis "without edge weights" (§1.2) as the
    workload-agnostic gold-standard starting point.
    """
    rng = np.random.default_rng(seed)
    base = _build_csr(g.n, g.src.copy(), g.dst.copy(), np.ones(g.m, dtype=np.float64))
    coarsen_to = coarsen_to or max(256, 32 * k)

    levels = [base]
    cg = base
    while cg.n > coarsen_to:
        nxt, _ = _heavy_edge_matching(cg, rng)
        if nxt.n >= cg.n * 0.95:  # matching stalled
            break
        levels.append(nxt)
        cg = nxt

    best_part, best_cut = None, np.inf
    for r in range(restarts):
        part = _region_grow_init(levels[-1], k, rng)
        part = _fm_refine(levels[-1], part, k, epsilon, refine_passes, rng)
        cut = _cut_of(levels[-1], part)
        if cut < best_cut:
            best_part, best_cut = part, cut
    part = best_part

    # uncoarsen with refinement at each level
    for lvl in range(len(levels) - 1, 0, -1):
        f2c = levels[lvl].fine_to_coarse
        part = part[f2c]
        part = _fm_refine(levels[lvl - 1], part, k, epsilon, refine_passes, rng)
    log.debug("metis_like: levels=%d final cut=%.0f", len(levels), _cut_of(base, part))
    return part.astype(np.int32)


def _cut_of(cg: _CoarseGraph, part: np.ndarray) -> float:
    cut = part[cg.src] != part[cg.dst]
    return float(cg.ewgt[cut].sum() / 2.0)
