"""Synthetic labelled-graph generators.

Two schema-constrained generators mirror the paper's test datasets:

* ``musicbrainz_like`` — 12 vertex labels, skewed sizes/degrees (paper §6.1.1
  uses a ~10M vertex MusicBrainz subset; we scale by parameter).
* ``provgen_like`` — PROV-DM graphs (Entity/Activity/Agent) following the
  ProvGen topological constraints (paper [6], §6.1.1).

Plus ``paper_example_graph`` — the exact 6-vertex graph of the paper's Fig. 1,
reconstructed from the worked examples in §4.2 and §5.4 (it reproduces every
number in those sections; see tests/test_visitor_oracle.py).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.graphs.graph import LabelledGraph

# ---------------------------------------------------------------------------
# Paper Fig. 1 example
# ---------------------------------------------------------------------------

#: labels of vertices 1..6 (0-indexed as 0..5)
_PAPER_LABELS = ["a", "b", "c", "d"]


def paper_example_graph() -> LabelledGraph:
    """The graph of the paper's Fig. 1 (vertex ids shifted to 0-base).

    Vertices (paper id: label): 1:a 2:b 3:c 4:d 5:c 6:a.
    Undirected edges: 1-2, 2-3, 2-4, 2-5, 3-4, 3-5, 3-6, 4-5.

    Derivation from the text: query ``c.(b|d)`` evaluates to paths
    (3,2),(3,4),(5,2),(5,4) (§1); vertex 2 has neighbours {1,3,4,5} (§4.2);
    vertex 3 has local neighbours {5,6} and external {2,4} w.r.t. partition
    B = {3,5,6} (§5.4); vertices 5 and 6 each have exactly one c-labelled
    neighbour, vertex 3 (probabilities in §5.2.1/§5.4).
    """
    labels = [0, 1, 2, 3, 2, 0]  # a b c d c a
    edges = np.array(
        [(0, 1), (1, 2), (1, 3), (1, 4), (2, 3), (2, 4), (2, 5), (3, 4)],
        dtype=np.int64,
    )
    return LabelledGraph.from_undirected_edges(6, labels, edges, list(_PAPER_LABELS))


def paper_example_partition() -> np.ndarray:
    """Partitioning used by §5.2.1/§5.4: A = {1,2,4}, B = {3,5,6} (1-based)."""
    return np.array([0, 0, 1, 0, 1, 1], dtype=np.int32)


# ---------------------------------------------------------------------------
# Schema-constrained generators
# ---------------------------------------------------------------------------


def _zipf_pick(rng: np.random.Generator, n: int, size: int, skew: float) -> np.ndarray:
    """Pick ``size`` vertex ranks in [0, n) with zipf-ish skew (0 = uniform)."""
    if n <= 0:
        raise ValueError("empty label class")
    u = rng.random(size)
    idx = np.floor(n * u ** (1.0 + skew)).astype(np.int64)
    return np.minimum(idx, n - 1)


def schema_graph(
    n: int,
    label_names: Sequence[str],
    label_props: Sequence[float],
    edge_schema: Sequence[Tuple[str, str, float]],
    avg_degree: float = 6.0,
    skew: float = 1.5,
    seed: int = 0,
    n_communities: Optional[int] = None,
    p_intra: float = 0.9,
) -> LabelledGraph:
    """Random heterogeneous graph over a label schema, with latent
    community structure.

    Real heterogeneous graphs (MusicBrainz, provenance) exhibit strong
    locality — an artist's credits/tracks/mediums cluster together, a
    provenance chain is a narrow DAG.  We model that with latent
    communities: each vertex belongs to one of ``n_communities`` blocks and
    an edge endpoint is drawn from the *same* block with probability
    ``p_intra`` (else globally).  Without this, the generator produces
    expander-like graphs that no partitioner (Metis included) can usefully
    split, which matches neither the paper's datasets nor its results.

    Args:
      n: vertex count.
      label_props: relative vertex proportions per label.
      edge_schema: (label_u, label_v, relative weight[, layer]) allowed edge
        types.  ``layer`` (default 0) selects which of two *independent*
        latent community assignments the edge type clusters by — relation
        groups in real data cluster along different axes (e.g. musical
        collaboration vs. web-link structure), which is exactly what gives a
        workload-aware partitioner headroom over min-edge-cut.
      avg_degree: target average (undirected) degree.
      skew: preferential-attachment skew (>0 = power-law-ish endpoints).
      n_communities: latent blocks (default: ~n/250, at least 8).
      p_intra: probability an edge stays within its block.
    """
    rng = np.random.default_rng(seed)
    props = np.asarray(label_props, dtype=np.float64)
    props = props / props.sum()
    counts = np.maximum(1, np.round(props * n).astype(np.int64))
    # adjust to sum exactly n
    counts[np.argmax(counts)] += n - counts.sum()
    name_to_id = {s: i for i, s in enumerate(label_names)}
    n_comm = n_communities or max(8, n // 250)
    n_layers = 1 + max((e[3] if len(e) > 3 else 0) for e in edge_schema)

    labels = np.repeat(np.arange(len(label_names), dtype=np.int32), counts)
    # vertex ids grouped by label; offsets per label
    offsets = np.concatenate([[0], np.cumsum(counts)])
    # latent communities per vertex and layer: within each label class,
    # vertices are striped over communities (layer 0) and independently
    # permuted per extra layer, so every (label, layer, community) cell is
    # non-empty and the layers are decorrelated
    comm = np.empty((n_layers, n), dtype=np.int64)
    for li in range(len(label_names)):
        lo, hi = offsets[li], offsets[li + 1]
        stripes = (np.arange(hi - lo) * n_comm) // max(hi - lo, 1)
        comm[0, lo:hi] = stripes
        for layer in range(1, n_layers):
            comm[layer, lo:hi] = stripes[rng.permutation(hi - lo)]
    # index vertices per (label, layer, community)
    cell_members = {}
    for li in range(len(label_names)):
        lo, hi = offsets[li], offsets[li + 1]
        for layer in range(n_layers):
            for c in range(n_comm):
                sel = lo + np.nonzero(comm[layer, lo:hi] == c)[0]
                if sel.size:
                    cell_members[(li, layer, c)] = sel

    target_edges = int(n * avg_degree / 2)
    weights = np.asarray([e[2] for e in edge_schema], dtype=np.float64)
    weights = weights / weights.sum()
    per_type = np.maximum(1, np.round(weights * target_edges).astype(np.int64))

    chunks = []
    for etype, cnt in zip(edge_schema, per_type):
        lu, lv = etype[0], etype[1]
        layer = etype[3] if len(etype) > 3 else 0
        iu, iv = name_to_id[lu], name_to_id[lv]
        cnt = int(cnt)
        us = offsets[iu] + _zipf_pick(rng, counts[iu], cnt, skew)
        # intra-community endpoints with probability p_intra (vectorised by
        # grouping the intra edges per source community)
        intra = rng.random(cnt) < p_intra
        vs = offsets[iv] + _zipf_pick(rng, counts[iv], cnt, skew)
        uc = comm[layer, us]
        intra_idx = np.nonzero(intra)[0]
        if intra_idx.size:
            order = np.argsort(uc[intra_idx], kind="stable")
            sorted_idx = intra_idx[order]
            sorted_comm = uc[sorted_idx]
            bounds = np.nonzero(np.diff(sorted_comm))[0] + 1
            for grp in np.split(sorted_idx, bounds):
                cell = cell_members.get((iv, layer, int(uc[grp[0]])))
                if cell is not None:
                    vs[grp] = cell[_zipf_pick(rng, cell.size, grp.size, skew)]
        chunks.append(np.stack([us, vs], axis=1))
    edges = np.concatenate(chunks, axis=0)
    g = LabelledGraph.from_undirected_edges(n, labels, edges, list(label_names))
    g.validate()
    return g


MUSICBRAINZ_LABELS = [
    "Area", "Artist", "Label", "Credit", "Track", "Recording",
    "Medium", "Release", "Work", "Place", "Genre", "Url",
]

_MB_PROPS = [0.01, 0.12, 0.02, 0.18, 0.28, 0.20, 0.05, 0.07, 0.04, 0.01, 0.005, 0.015]

_MB_SCHEMA = [
    # core music-collaboration relations (clustered by release group): layer 0
    ("Artist", "Area", 1.0, 0),
    ("Artist", "Credit", 4.0, 0),
    ("Credit", "Track", 5.0, 0),
    ("Credit", "Recording", 4.0, 0),
    ("Track", "Medium", 3.0, 0),
    ("Medium", "Release", 1.0, 0),
    ("Release", "Label", 0.8, 0),
    ("Label", "Area", 0.3, 0),
    ("Recording", "Work", 1.0, 0),
    # auxiliary relations clustered along an independent axis (web links,
    # taxonomies, geography): layer 1 — volume the unweighted min-cut
    # objective must serve, but MQ1-MQ3 never traverse
    ("Artist", "Url", 1.2, 1),
    ("Artist", "Genre", 1.5, 1),
    ("Place", "Area", 0.6, 1),
    ("Artist", "Place", 0.7, 1),
    ("Url", "Url", 1.0, 1),
    ("Genre", "Genre", 0.5, 1),
]


def musicbrainz_like(n: int = 20_000, avg_degree: float = 6.0, seed: int = 0) -> LabelledGraph:
    """Heterogeneous music-metadata graph (12 labels), paper §6.1.1 analogue."""
    return schema_graph(
        n, MUSICBRAINZ_LABELS, _MB_PROPS, _MB_SCHEMA,
        avg_degree=avg_degree, skew=1.5, seed=seed,
    )


PROV_LABELS = ["Entity", "Activity", "Agent"]

_PROV_SCHEMA = [
    # data-flow relations (clustered by workflow run): layer 0
    ("Entity", "Entity", 3.0, 0),      # wasDerivedFrom
    ("Entity", "Activity", 3.0, 0),    # wasGeneratedBy / used
    ("Activity", "Agent", 1.0, 0),     # wasAssociatedWith
    ("Entity", "Agent", 0.7, 0),       # wasAttributedTo
    # control-flow / organisational relations clustered independently
    # (scheduler batches, org charts): layer 1 — not traversed by PQ1-PQ4
    ("Activity", "Activity", 2.2, 1),  # wasInformedBy
    ("Agent", "Agent", 0.8, 1),        # actedOnBehalfOf
]


def provgen_like(n: int = 20_000, avg_degree: float = 6.0, seed: int = 0) -> LabelledGraph:
    """PROV-DM provenance graph (3 labels), ProvGen analogue (paper §6.1.1)."""
    return schema_graph(
        n, PROV_LABELS, [0.6, 0.3, 0.1], _PROV_SCHEMA,
        avg_degree=avg_degree, skew=1.2, seed=seed,
    )
