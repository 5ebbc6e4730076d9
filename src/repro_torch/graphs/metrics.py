"""Partitioning quality metrics (workload-agnostic ones; ipt lives in
repro_torch.workload.executor since it needs query execution)."""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.graph import LabelledGraph


def edge_cut(g: LabelledGraph, part: np.ndarray, directed: bool = False) -> int:
    """Number of edges crossing partitions.

    ``directed=True`` counts cut *arcs* — every stored directed edge whose
    endpoints differ.  ``directed=False`` (default) counts each undirected
    pair once; arcs without a stored reverse still count once each (the old
    implementation's blanket ``// 2`` silently halved those).
    """
    cut = part[g.src] != part[g.dst]
    if directed:
        return int(cut.sum())
    # count each symmetric pair at its (src < dst) arc; one-directional
    # arcs (no stored reverse) are their own representative
    once = (g.src < g.dst) | (g.reverse_edge_index < 0)
    return int((cut & once).sum())


def partition_sizes(part: np.ndarray, k: int) -> np.ndarray:
    return np.bincount(part, minlength=k)


def partition_balance(part: np.ndarray, k: int) -> float:
    """max partition size / ideal size; 1.0 = perfectly balanced."""
    sizes = partition_sizes(part, k)
    ideal = part.shape[0] / k
    return float(sizes.max() / ideal) if ideal > 0 else 1.0
