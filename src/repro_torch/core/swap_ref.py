"""Seed (pre-vectorisation) swap implementation — kept as the parity oracle.

This is the original per-vertex Python implementation of ``swap_iteration``:
flood-fill families via per-neighbour ``np.searchsorted`` reverse-edge
lookups and per-destination gain loops.  ``repro_torch.core.swap``
re-implements the same semantics with frontier-batched numpy; the parity
suite (tests/test_torch_swap_ref.py) holds the two bit-identical on random
labelled graphs.

Do not optimise this module — its value is being the unchanged oracle.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.swap import SwapConfig, SwapStats
from repro_torch.core.visitor import ExtroversionResult
from repro_torch.graphs.graph import LabelledGraph


def _edge_indices_from(g: LabelledGraph, u: int) -> Tuple[np.ndarray, np.ndarray]:
    lo, hi = g.row_ptr[u], g.row_ptr[u + 1]
    return np.arange(lo, hi, dtype=np.int64), g.dst[lo:hi]


def _edge_index(g: LabelledGraph, u: int, w: int) -> Optional[int]:
    """Index of directed edge (u, w) in the CSR-sorted edge list, or None."""
    lo, hi = g.row_ptr[u], g.row_ptr[u + 1]
    j = np.searchsorted(g.dst[lo:hi], w)
    if j < hi - lo and g.dst[lo + j] == w:
        return int(lo + j)
    return None


def _family_of(
    g: LabelledGraph,
    v: int,
    part: np.ndarray,
    moved: np.ndarray,
    rel_mass_out: np.ndarray,
    cfg: SwapConfig,
) -> List[int]:
    """Flood-fill family: local vertices likely (> threshold) to traverse
    *to* a current member (paper §5.5)."""
    home = part[v]
    fam = [v]
    in_fam = {v}
    frontier = [v]
    while frontier and len(fam) < cfg.family_max_size:
        nxt: List[int] = []
        for w in frontier:
            eidx, nbrs = _edge_indices_from(g, w)
            if nbrs.size > cfg.max_scan_neighbors:
                keep = np.argsort(-rel_mass_out[eidx])[: cfg.max_scan_neighbors]
                eidx, nbrs = eidx[keep], nbrs[keep]
            for u in nbrs:
                u = int(u)
                if u in in_fam or part[u] != home or moved[u]:
                    continue
                rev = _edge_index(g, u, w)
                if rev is None:
                    continue
                if rel_mass_out[rev] > cfg.family_threshold:
                    fam.append(u)
                    in_fam.add(u)
                    nxt.append(u)
                    if len(fam) >= cfg.family_max_size:
                        break
            if len(fam) >= cfg.family_max_size:
                break
        frontier = nxt
    return fam


def _family_gain(
    g: LabelledGraph,
    fam: List[int],
    dest: int,
    part: np.ndarray,
    edge_mass: np.ndarray,
) -> Tuple[float, float]:
    """(receiver_gain, sender_loss) in traversal-probability mass."""
    in_fam = set(fam)
    home = part[fam[0]]
    gain = loss = 0.0
    for w in fam:
        eidx, nbrs = _edge_indices_from(g, w)
        for e, u in zip(eidx, nbrs):
            u = int(u)
            if u in in_fam:
                continue
            m_out = float(edge_mass[e])
            rev = _edge_index(g, u, w)
            m_in = float(edge_mass[rev]) if rev is not None else 0.0
            if part[u] == dest:
                gain += m_out + m_in
            elif part[u] == home:
                loss += m_out + m_in
    return gain, loss


def swap_iteration_reference(
    g: LabelledGraph,
    part: np.ndarray,
    field: ExtroversionResult,
    k: int,
    cfg: SwapConfig,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, SwapStats]:
    """One internal TAPER iteration of offer/receive vertex swapping (seed)."""
    part = part.astype(np.int32).copy()
    n = g.n
    sizes = np.bincount(part, minlength=k).astype(np.int64)
    ideal = n / k
    max_size = int(np.floor((1.0 + cfg.balance_eps) * ideal))
    min_size = int(np.ceil((1.0 - cfg.balance_eps) * ideal))

    pr_src = np.maximum(field.pr[g.src], 1e-30)
    rel_mass_out = field.edge_mass / pr_src

    ext = field.extroversion if cfg.rank_by == "extroversion" else field.extro_mass
    candidates: List[int] = []
    for p in range(k):
        members = np.nonzero(part == p)[0]
        if members.size == 0:
            continue
        unsafe = field.extroversion[members] > (1.0 - cfg.safe_introversion)
        members = members[unsafe]
        if members.size == 0:
            continue
        top = members[np.argsort(-ext[members])]
        if cfg.candidates_per_part is not None:
            top = top[: cfg.candidates_per_part]
        candidates.extend(int(v) for v in top)
    candidates.sort(key=lambda v: -ext[v])

    moved = np.zeros(n, dtype=bool)
    stats = SwapStats(0, 0, 0, len(candidates))

    for v in candidates:
        if moved[v]:
            continue
        home = part[v]
        if field.ext_to is not None:
            prefs = field.ext_to[v].copy()
        else:
            prefs = np.zeros(k)
            eidx, nbrs = _edge_indices_from(g, v)
            is_cut = part[nbrs] != home
            np.add.at(prefs, part[nbrs[is_cut]], field.edge_mass[eidx[is_cut]])
        prefs[home] = -np.inf
        order = np.argsort(-prefs)
        fam = _family_of(g, v, part, moved, rel_mass_out, cfg)
        fs = len(fam)
        for dest in order:
            dest = int(dest)
            if prefs[dest] <= 0.0:
                break
            if sizes[dest] + fs > max_size or sizes[home] - fs < min_size:
                stats.rejected_offers += 1
                continue
            gain, loss = _family_gain(g, fam, dest, part, field.edge_mass)
            if gain > loss + cfg.min_gain:
                part[list(fam)] = dest
                moved[list(fam)] = True
                sizes[home] -= fs
                sizes[dest] += fs
                stats.moves += fs
                stats.accepted_offers += 1
                break
            stats.rejected_offers += 1
    return part, stats
