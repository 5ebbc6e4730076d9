"""Vertex swapping (paper §3.1, §5.5) — frontier-batched numpy engine.

Per TAPER internal iteration:

1. take each partition's most extroverted vertices, in descending
   extroversion order (NOT random boundary vertices — paper §3.1);
2. for each candidate, compute its preferred destination partitions (by
   external mass, descending) and its *family* — the flood-fill closure of
   local vertices whose traversal probability toward a member is "more
   likely than not" (paper §5.5);
3. cooperative offer/receive: the receiving partition accepts only when its
   introversion gain exceeds the sender's loss; otherwise try the next
   destination (paper §5.5, Fig. 6);
4. a vertex moves at most once per iteration; a 5% balance constraint is
   enforced (paper §6.2.1).

All probability masses come precomputed from the extroversion field (the
device DP).  This module is a verbatim numpy port of the JAX package's
``core/swap.py``: given the same field it returns the bitwise same partition
and ``SwapStats`` (tests/test_torch_taper.py).  All per-family work is
whole-frontier array operations:

* family expansion expands an entire BFS frontier per step — one
  concatenated CSR slice, one gather of the cached
  ``LabelledGraph.reverse_edge_index``, one first-occurrence dedup;
* family gain/loss is a single masked segment-sum (``np.bincount``) over the
  family's incident edge set, yielding the gains toward *all* ``k``
  destinations at once (the seed recomputed a Python loop per destination).

Internal iterations are therefore "inexpensive" in the paper's sense (§5):
per-candidate cost is a handful of O(family-degree) vector ops.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.visitor import ExtroversionResult
from repro_torch.graphs.graph import LabelledGraph
from repro_torch.utils import get_logger

log = get_logger("core.swap")


@dataclass
class SwapConfig:
    candidates_per_part: Optional[int] = None  # None = drain the whole queue (§5.5)
    family_threshold: float = 0.5     # "more likely than not"
    family_max_size: int = 12
    balance_eps: float = 0.05         # paper: max 5% imbalance
    min_gain: float = 0.0
    safe_introversion: float = 0.95   # §5.2.1 safe-vertex threshold
    max_scan_neighbors: int = 512     # hub guard in family flood fill
    rank_by: str = "extroversion"     # "extroversion" (paper §3.2 ratio) or
                                      # "mass" (absolute external mass; beyond-paper)


@dataclass
class SwapStats:
    moves: int
    accepted_offers: int
    rejected_offers: int
    candidates: int


def _concat_csr_edges(
    g: LabelledGraph, vs: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """``LabelledGraph.edge_indices_of`` plus the per-vertex edge counts."""
    cnts = g.row_ptr[vs + 1] - g.row_ptr[vs]
    return g.edge_indices_of(vs), cnts


def _frontier_edge_indices(
    g: LabelledGraph, frontier: np.ndarray, rel_mass_out: np.ndarray, cap: int
) -> np.ndarray:
    """Concatenated CSR edge indices of every frontier vertex, in frontier
    order (each vertex's edges in CSR order).  Vertices whose degree exceeds
    ``cap`` keep only their ``cap`` highest-``rel_mass_out`` edges — the same
    hub guard (and the same tie-breaking ``argsort`` call) as the seed."""
    starts = g.row_ptr[frontier]
    cnts = g.row_ptr[frontier + 1] - starts
    if not (cnts > cap).any():
        return _concat_csr_edges(g, frontier)[0]
    chunks: List[np.ndarray] = []
    for lo, c in zip(starts, cnts):
        eidx = np.arange(lo, lo + c, dtype=np.int64)
        if c > cap:
            keep = np.argsort(-rel_mass_out[eidx])[:cap]
            eidx = eidx[keep]
        chunks.append(eidx)
    return np.concatenate(chunks)


def _family_of(
    g: LabelledGraph,
    v: int,
    part: np.ndarray,
    moved: np.ndarray,
    rel_mass_out: np.ndarray,
    rev: np.ndarray,
    cfg: SwapConfig,
) -> np.ndarray:
    """Flood-fill family: local vertices likely (> threshold) to traverse
    *to* a current member (paper §5.5).  rel_mass_out[e] = edge_mass[e] /
    Pr(src[e]) — the probability that a traversal out of src follows e.

    Whole frontiers expand at once: for frontier edges ``e = (w, u)`` the
    membership test reads the reverse edge ``(u, w)`` through the cached
    ``reverse_edge_index`` gather, and candidates join in first-occurrence
    order (identical to the seed's sequential scan) up to
    ``family_max_size``."""
    home = part[v]
    fam = np.array([v], dtype=np.int64)
    frontier = fam
    while frontier.size and fam.size < cfg.family_max_size:
        eidx = _frontier_edge_indices(g, frontier, rel_mass_out,
                                      cfg.max_scan_neighbors)
        if eidx.size == 0:
            break
        nbrs = g.dst[eidx].astype(np.int64)
        # traversal from u to w is the reverse edge (u, w) of e = (w, u)
        r = rev[eidx]
        ok = (
            (part[nbrs] == home)
            & ~moved[nbrs]
            & (r >= 0)
            & ~np.isin(nbrs, fam)
            # r == -1 rows are already masked; the clamped gather is harmless
            & (rel_mass_out[np.maximum(r, 0)] > cfg.family_threshold)
        )
        cand = nbrs[ok]
        if cand.size == 0:
            break
        # first-occurrence dedup preserves the seed's sequential join order
        _, first = np.unique(cand, return_index=True)
        cand = cand[np.sort(first)]
        room = cfg.family_max_size - fam.size
        cand = cand[:room]
        fam = np.concatenate([fam, cand])
        frontier = cand
    return fam


def _family_gains(
    g: LabelledGraph,
    fam: np.ndarray,
    part: np.ndarray,
    edge_mass: np.ndarray,
    rev: np.ndarray,
    k: int,
) -> np.ndarray:
    """``(k,)`` float64 — traversal mass between the family and *each*
    partition (both edge directions), as one masked segment-sum over the
    family's incident edges.

    ``gains[dest]`` is the receiver gain of moving the family to ``dest``;
    ``gains[home]`` is the sender loss.  Family-internal edges move with the
    family and edges to third partitions stay cut, so neither affects the
    decision.  (The seed recomputed this with Python loops once per
    destination attempt.)"""
    eidx, _ = _concat_csr_edges(g, fam)
    if eidx.size == 0:
        return np.zeros(k, dtype=np.float64)
    nbrs = g.dst[eidx].astype(np.int64)
    ext = ~np.isin(nbrs, fam)
    eidx, nbrs = eidx[ext], nbrs[ext]
    r = rev[eidx]
    m = edge_mass[eidx].astype(np.float64) + np.where(
        r >= 0, edge_mass[np.maximum(r, 0)].astype(np.float64), 0.0)
    return np.bincount(part[nbrs], weights=m, minlength=k)


def _candidate_queue(
    part: np.ndarray,
    field: ExtroversionResult,
    k: int,
    cfg: SwapConfig,
    candidate_mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Most extroverted vertices per partition (safe ones skipped, §5.2.1),
    merged into one globally descending queue (paper §3.1).

    ``candidate_mask`` restricts the queue to a vertex subset — the dirty
    frontier of mutated vertices for mutation-local online invocations
    (paper §5.5's queue pruning generalised to topology deltas)."""
    ext = field.extroversion if cfg.rank_by == "extroversion" else field.extro_mass
    per_part: List[np.ndarray] = []
    for p in range(k):
        members = np.nonzero(part == p)[0]
        if candidate_mask is not None and members.size:
            members = members[candidate_mask[members]]
        if members.size == 0:
            continue
        # §5.2.1: vertices with introversion above the safe threshold are
        # discarded (they cannot be good swap candidates)
        unsafe = field.extroversion[members] > (1.0 - cfg.safe_introversion)
        members = members[unsafe]
        if members.size == 0:
            continue
        top = members[np.argsort(-ext[members])]
        if cfg.candidates_per_part is not None:
            top = top[: cfg.candidates_per_part]
        per_part.append(top.astype(np.int64))
    if not per_part:
        return np.empty(0, dtype=np.int64)
    candidates = np.concatenate(per_part)
    # stable sort keeps the per-partition order on ties, like the seed's
    # Python list.sort(key=-ext)
    return candidates[np.argsort(-ext[candidates], kind="stable")]


def _lazy_prefs(
    g: LabelledGraph, v: int, home: int, part: np.ndarray,
    field: ExtroversionResult, k: int
) -> np.ndarray:
    """Two-phase path (§Perf-T2): per-destination preference computed lazily
    from the candidate's own cut edges.  The ``bincount`` accumulates the
    float32 masses into float64 in edge order — the same arithmetic as the
    seed's ``np.add.at``."""
    lo, hi = int(g.row_ptr[v]), int(g.row_ptr[v + 1])
    pn = part[g.dst[lo:hi]]
    cut = pn != home
    # .astype: bincount of an empty input yields int64 zeros
    return np.bincount(
        pn[cut],
        weights=field.edge_mass[lo:hi][cut].astype(np.float64),
        minlength=k).astype(np.float64)


def swap_iteration(
    g: LabelledGraph,
    part: np.ndarray,
    field: ExtroversionResult,
    k: int,
    cfg: SwapConfig,
    rng: np.random.Generator,
    candidate_mask: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, SwapStats]:
    """One internal TAPER iteration of offer/receive vertex swapping.

    ``candidate_mask`` (optional ``(n,)`` bool) seeds the candidate queue
    from a vertex subset only — used by ``OnlineTaper`` to run
    mutation-local invocations over the dirty frontier; ``None`` keeps the
    full paper §3.1 queue.

    Produces bit-identical partitions and stats to the per-vertex seed
    implementation of the JAX package, but amortises almost all
    per-candidate work into whole-array precomputes:

    * the *joinable* relation (which neighbour can ever enter a family) only
      shrinks during an iteration — vertices leave it by being moved, and
      ``part`` changes only for moved vertices — so a candidate whose family
      is a singleton at iteration start stays a singleton.  Singleton
      candidates (the vast majority under the 0.5 "more likely than not"
      threshold) get their k-destination gain rows and preference rows from
      two batched ``bincount``/``argsort`` passes over the whole candidate
      set;
    * the sequential offer/receive walk then runs in plain Python over those
      precomputed rows; a batched row is re-derived per candidate only when
      a vertex in its 1-hop neighbourhood has moved since the batch (the
      gains/prefs of v depend only on ``part``/``moved`` over N(v) ∪ {v});
    * candidates with multi-member families take the frontier-batched
      ``_family_of`` / ``_family_gains`` path against live state.
    """
    part = part.astype(np.int32).copy()
    n = g.n
    sizes = np.bincount(part, minlength=k).astype(np.int64)
    ideal = n / k
    max_size = int(np.floor((1.0 + cfg.balance_eps) * ideal))
    min_size = int(np.ceil((1.0 - cfg.balance_eps) * ideal))

    pr_src = np.maximum(field.pr[g.src], 1e-30)
    rel_mass_out = field.edge_mass / pr_src
    rev = g.reverse_edge_index
    rev_ok = rev >= 0
    rev_c = np.maximum(rev, 0)

    candidates = _candidate_queue(part, field, k, cfg, candidate_mask)
    moved = np.zeros(n, dtype=bool)
    stats = SwapStats(0, 0, 0, int(candidates.size))
    if candidates.size == 0:
        return part, stats

    # ---- whole-iteration precomputes --------------------------------------
    # symmetric edge mass m_out + m_in, in the seed's float64 arithmetic
    sym_mass = field.edge_mass.astype(np.float64) + np.where(
        rev_ok, field.edge_mass[rev_c].astype(np.float64), 0.0)
    # rel_mass_out of the reverse edge (u -> w traversal for edge e=(w, u))
    rel_rev = np.where(rev_ok, rel_mass_out[rev_c], -np.inf)
    # an edge can recruit its dst into src's family ("joinable"); this set
    # only shrinks as vertices move, so it is computed once per iteration
    join_e = (part[g.src] == part[g.dst]) & (rel_rev > cfg.family_threshold)
    has_join = np.zeros(n, dtype=bool)
    has_join[g.src[join_e]] = True
    is_single = ~has_join[candidates]

    # ---- batched gain/pref rows for singleton-family candidates -----------
    S = candidates[is_single]
    row_of = np.full(candidates.size, -1, dtype=np.int64)
    row_of[is_single] = np.arange(S.size)
    dense = field.ext_to is not None
    if S.size:
        eidx, s_cnts = _concat_csr_edges(g, S)
        cid = np.repeat(np.arange(S.size, dtype=np.int64), s_cnts)
        nbr = g.dst[eidx].astype(np.int64)
        notself = nbr != np.repeat(S, s_cnts)
        e_i, c_i, n_i = eidx[notself], cid[notself], nbr[notself]
        # .astype guards: bincount of an empty input yields int64 zeros
        gains_mat = np.bincount(
            c_i * k + part[n_i], weights=sym_mass[e_i], minlength=S.size * k
        ).astype(np.float64).reshape(S.size, k)
        if dense:
            prefs_mat = field.ext_to[S].copy()
        else:
            cut = part[n_i] != part[S][c_i]
            prefs_mat = np.bincount(
                c_i[cut] * k + part[n_i[cut]],
                weights=field.edge_mass[e_i[cut]].astype(np.float64),
                minlength=S.size * k,
            ).astype(np.float64).reshape(S.size, k)
        prefs_mat[np.arange(S.size), part[S]] = -np.inf
        order_mat = np.argsort(-prefs_mat, axis=1)
        gains_rows = gains_mat.tolist()
        prefs_rows = prefs_mat.tolist()
        order_rows = order_mat.tolist()
    else:
        gains_rows = prefs_rows = order_rows = []

    # ---- sequential offer/receive walk (pure Python on cached rows) -------
    rp = g.row_ptr.tolist()
    dl = g.dst.tolist()
    cand_list = candidates.tolist()
    row_list = row_of.tolist()
    single_list = is_single.tolist()
    dirty = bytearray(n)  # vertices whose part/moved changed since the batch
    sizes_l = sizes.tolist()
    min_gain = cfg.min_gain

    for ci, v in enumerate(cand_list):
        if moved[v]:
            continue
        home = int(part[v])
        if single_list[ci]:
            fresh = not dirty[v]
            if fresh:
                for j in range(rp[v], rp[v + 1]):
                    if dirty[dl[j]]:
                        fresh = False
                        break
            row = row_list[ci]
            if fresh:
                gains = gains_rows[row]
                prefs = prefs_rows[row]
                order = order_rows[row]
            else:
                # 1-hop state changed: re-derive from live part[] (same
                # arithmetic as the batch).  Preference rows built from
                # ext_to are static — only the two-phase lazy prefs depend
                # on neighbours' partitions; gains re-derive lazily below,
                # only once a destination passes the balance check.
                if dense:
                    prefs = prefs_rows[row]
                    order = order_rows[row]
                else:
                    prefs_a = _lazy_prefs(g, v, home, part, field, k)
                    prefs_a[home] = -np.inf
                    order = np.argsort(-prefs_a)
                    prefs = prefs_a
                gains = None
            for dest in order:
                if prefs[dest] <= 0.0:
                    break  # no external mass toward remaining partitions
                if (sizes_l[dest] + 1 > max_size
                        or sizes_l[home] - 1 < min_size):
                    stats.rejected_offers += 1
                    continue
                if gains is None:
                    lo, hi = rp[v], rp[v + 1]
                    nbrs = g.dst[lo:hi]
                    ns = nbrs != v
                    gains = np.bincount(part[nbrs[ns]],
                                        weights=sym_mass[lo:hi][ns],
                                        minlength=k)
                if gains[dest] > gains[home] + min_gain:
                    part[v] = dest
                    moved[v] = True
                    dirty[v] = 1
                    sizes_l[home] -= 1
                    sizes_l[dest] += 1
                    stats.moves += 1
                    stats.accepted_offers += 1
                    break
                stats.rejected_offers += 1
            continue

        # ---- multi-member family: frontier-batched path on live state ----
        if dense:
            prefs_a = field.ext_to[v].copy()
        else:
            prefs_a = _lazy_prefs(g, v, home, part, field, k)
        prefs_a[home] = -np.inf
        order_a = np.argsort(-prefs_a)
        fam = _family_of(g, v, part, moved, rel_mass_out, rev, cfg)
        fs = int(fam.size)
        gains_a = None  # computed on the first destination passing balance
        for dest in order_a:
            dest = int(dest)
            if prefs_a[dest] <= 0.0:
                break
            if sizes_l[dest] + fs > max_size or sizes_l[home] - fs < min_size:
                stats.rejected_offers += 1
                continue
            if gains_a is None:
                gains_a = _family_gains(g, fam, part, field.edge_mass, rev, k)
            if float(gains_a[dest]) > float(gains_a[home]) + min_gain:
                part[fam] = dest
                moved[fam] = True
                for u in fam.tolist():
                    dirty[u] = 1
                sizes_l[home] -= fs
                sizes_l[dest] += fs
                stats.moves += fs
                stats.accepted_offers += 1
                break
            stats.rejected_offers += 1
    return part, stats
