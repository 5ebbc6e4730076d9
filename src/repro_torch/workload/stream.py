"""Query workload and graph-topology streams (paper §6.1.2 + online TAPER).

The paper's experiments use a periodic model where each query pattern's
frequency grows and shrinks "similar to a sin wave", complementary so the
total is always 1; plus (Fig. 10) a linear drift between two queries.

:class:`GraphMutationStream` is the topology twin: it emits per-tick
:class:`repro_torch.graphs.graph.MutationBatch` batches under grow / churn /
burst / mixed scenarios, driving the "changes in the graph topology" half
of the paper's adaptivity claim."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.rpq import RPQ
from repro_torch.graphs.graph import LabelledGraph, MutationBatch


def periodic_frequencies(
    n_queries: int, t: float, period: float = 1.0, floor: float = 0.02
) -> np.ndarray:
    """Relative frequencies at time ``t``: phase-shifted raised sines,
    normalised to sum to 1 (paper §6.1.2)."""
    phases = 2 * np.pi * (np.arange(n_queries) / n_queries)
    raw = 1.0 + np.sin(2 * np.pi * t / period + phases)
    raw = np.maximum(raw, floor)
    return raw / raw.sum()


def linear_drift(t: float) -> np.ndarray:
    """Fig. 10 model: two queries, Q_a 100%->0% linearly, Q_b 0%->100%."""
    a = float(np.clip(1.0 - t, 0.0, 1.0))
    return np.array([a, 1.0 - a])


@dataclass
class WorkloadStream:
    """Infinite stream of query instances with time-varying frequencies."""

    queries: Sequence[RPQ]
    period: float = 1.0
    mode: str = "periodic"            # "periodic" | "linear" | "static"
    static_freqs: Sequence[float] = ()
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self.t = 0.0

    def frequencies(self) -> np.ndarray:
        if self.mode == "periodic":
            return periodic_frequencies(len(self.queries), self.t, self.period)
        if self.mode == "linear":
            assert len(self.queries) == 2
            return linear_drift(self.t)
        freqs = np.asarray(self.static_freqs, dtype=np.float64)
        return freqs / freqs.sum()

    def workload(self) -> List[Tuple[RPQ, float]]:
        """Exact current workload snapshot [(query, frequency)]."""
        return list(zip(self.queries, self.frequencies().tolist()))

    def sample(self, batch_size: int) -> List[RPQ]:
        """Sample a batch of query instances at the current time."""
        idx = self._rng.choice(len(self.queries), size=batch_size, p=self.frequencies())
        return [self.queries[i] for i in idx]

    def advance(self, dt: float) -> None:
        self.t += dt


@dataclass
class GraphMutationStream:
    """Stream of per-tick topology mutation batches.

    Scenarios (``mode``):

    * ``"grow"``  — ``vertices_per_tick`` new vertices arrive each tick,
      labels drawn from the current label distribution, each attaching
      ``attach_degree`` edges to existing vertices by preferential
      attachment (degree-proportional).
    * ``"churn"`` — constant size: ``edges_per_tick`` random existing
      undirected edges are removed and the same number of fresh random
      edges inserted.
    * ``"burst"`` — quiet ticks punctuated every ``burst_every`` ticks by a
      ``burst_scale``-times mixed batch (arrival spike).
    * ``"mixed"`` — grow + churn combined in one batch per tick (the
      combined topology-drift scenario; one batch keeps downstream
      incremental caches patchable in a single hop).

    ``next_batch(g)`` samples against the *current* graph, so apply the
    returned batch before requesting the next one.
    """

    mode: str = "mixed"              # "grow" | "churn" | "burst" | "mixed"
    vertices_per_tick: int = 4
    edges_per_tick: int = 16
    attach_degree: int = 3
    burst_every: int = 5
    burst_scale: int = 8
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self.tick = 0

    # -- scenario pieces ----------------------------------------------------
    def _grow_parts(self, g: LabelledGraph, nv: int):
        if nv <= 0:
            return [], np.zeros((0, 2), np.int64)
        lab_freq = np.bincount(g.labels, minlength=g.n_labels).astype(np.float64)
        lab_freq = lab_freq / max(lab_freq.sum(), 1.0)
        labels = self._rng.choice(g.n_labels, size=nv, p=lab_freq)
        deg = (g.row_ptr[1:] - g.row_ptr[:-1]).astype(np.float64) + 1.0
        p = deg / deg.sum()
        edges = []
        for i in range(nv):
            targets = self._rng.choice(
                g.n, size=min(self.attach_degree, g.n), replace=False, p=p)
            edges.extend((g.n + i, int(t)) for t in targets)
        return labels.tolist(), np.asarray(edges, np.int64).reshape(-1, 2)

    def _churn_parts(self, g: LabelledGraph, ne: int):
        if ne <= 0 or g.m == 0:
            z = np.zeros((0, 2), np.int64)
            return z, z
        fwd = np.nonzero(g.src < g.dst)[0]
        take = min(ne, fwd.size)
        rem_idx = self._rng.choice(fwd.size, size=take, replace=False)
        remove = np.stack(
            [g.src[fwd[rem_idx]], g.dst[fwd[rem_idx]]], axis=1).astype(np.int64)
        add = np.stack([
            self._rng.integers(0, g.n, size=ne),
            self._rng.integers(0, g.n, size=ne),
        ], axis=1).astype(np.int64)
        return remove, add

    def next_batch(self, g: LabelledGraph) -> MutationBatch:
        self.tick += 1
        scale = 1
        mode = self.mode
        if mode == "burst":
            if self.tick % self.burst_every:
                return MutationBatch()
            scale, mode = self.burst_scale, "mixed"
        nv = self.vertices_per_tick * scale if mode in ("grow", "mixed") else 0
        ne = self.edges_per_tick * scale if mode in ("churn", "mixed") else 0
        labels, grow_edges = self._grow_parts(g, nv)
        remove, churn_add = self._churn_parts(g, ne)
        add = (np.concatenate([grow_edges, churn_add], axis=0)
               if grow_edges.size or churn_add.size
               else np.zeros((0, 2), np.int64))
        return MutationBatch(
            add_vertex_labels=labels, add_edges=add, remove_edges=remove)
