"""Mutation ingest: bounded queue of :class:`MutationBatch` with coalescing.

The ingest path of the serving subsystem: producers submit topology deltas
(:meth:`IngestQueue.submit`, bounded with the same backpressure contract as
the request queue) and the serving loop drains them *between* TAPER
invocations — the graph must stay immutable while a field evaluation is in
flight on another thread — applying each through
``LabelledGraph.apply_mutations`` so every derived cache (CSR arrays,
reverse index, neighbour-label counts, per-shard ``vm_packing_sharded``
entries) is merge-patched rather than rebuilt, and the next sharded field
evaluation re-uploads only the dirty shards.

:func:`coalesce_mutations` folds a backlog of batches into (usually) one
equivalent batch before applying, so a burst of small deltas costs one
merge-patch pass instead of many.  The fold is *order-aware*: each edge's
final presence is decided by the last operation that names it, matching
the sequential apply semantics exactly ("removals before additions" holds
only *within* one batch).  One interaction cannot be expressed in a single
batch — an edge added *after* one of its endpoints was removed by an
earlier batch (``apply_mutations`` drops additions touching a same-batch
removed vertex) — so the fold splits into a new group at that point and
returns more than one batch, applied in order.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

from repro_torch.graphs.graph import MutationBatch
from repro_torch.serve.queueing import Rejection


def _normalized_edges(edges) -> List[Tuple[int, int]]:
    arr = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    lo = np.minimum(arr[:, 0], arr[:, 1])
    hi = np.maximum(arr[:, 0], arr[:, 1])
    return list(zip(lo.tolist(), hi.tolist()))


class _Group:
    """One coalesced batch under construction."""

    def __init__(self):
        self.labels: List[int] = []
        self.edge_ops: Dict[Tuple[int, int], str] = {}  # key -> add|remove
        self.removed_vs: set = set()
        self.relabel: Dict[int, int] = {}
        self.members: List[MutationBatch] = []

    def conflicts(self, batch: MutationBatch) -> bool:
        """True when folding ``batch`` in would change semantics: it re-adds
        an edge incident to a vertex an earlier batch removed."""
        if not self.removed_vs or not len(batch.add_edges):
            return False
        return any(a in self.removed_vs or b in self.removed_vs
                   for a, b in _normalized_edges(batch.add_edges))

    def fold(self, batch: MutationBatch) -> None:
        self.labels.extend(int(x) for x in batch.add_vertex_labels)
        # within one source batch removals precede additions, matching
        # apply_mutations; across batches the last op per edge key wins
        for key in _normalized_edges(batch.remove_edges):
            self.edge_ops[key] = "remove"
        for key in _normalized_edges(batch.add_edges):
            self.edge_ops[key] = "add"
        self.removed_vs.update(int(v) for v in batch.remove_vertices)
        for v, lab in np.asarray(
                batch.relabel, dtype=np.int64).reshape(-1, 2).tolist():
            self.relabel[int(v)] = int(lab)
        self.members.append(batch)

    def to_batch(self) -> MutationBatch:
        add = [k for k, op in self.edge_ops.items() if op == "add"]
        rem = [k for k, op in self.edge_ops.items() if op == "remove"]
        return MutationBatch(
            add_vertex_labels=self.labels,
            add_edges=np.asarray(add, np.int64).reshape(-1, 2),
            remove_edges=np.asarray(rem, np.int64).reshape(-1, 2),
            remove_vertices=sorted(self.removed_vs),
            relabel=[(v, l) for v, l in self.relabel.items()],
        )


def coalesce_groups(
    batches: Sequence[MutationBatch],
) -> List[Tuple[MutationBatch, List[MutationBatch]]]:
    """Fold pending batches into the fewest equivalent batches (see module
    docstring), returning each fold with its original member batches —
    consumers that hit a validation error on a fold can fall back to the
    members individually, so one malformed producer batch never discards
    the valid batches coalesced with it."""
    groups: List[_Group] = []
    for b in batches:
        if b.is_empty:
            continue
        if not groups or groups[-1].conflicts(b):
            groups.append(_Group())
        groups[-1].fold(b)
    return [(grp.to_batch(), grp.members) for grp in groups]


def coalesce_mutations(
    batches: Sequence[MutationBatch],
) -> List[MutationBatch]:
    """Fold pending batches into the fewest equivalent batches (see module
    docstring).  Applying the result in order to a graph produces arrays
    bit-identical to applying the originals in order."""
    return [merged for merged, _ in coalesce_groups(batches)]


class IngestQueue:
    """Thread-safe bounded FIFO of :class:`MutationBatch`."""

    def __init__(self, max_depth: int = 64):
        if max_depth < 1:
            raise ValueError("max_depth must be >= 1")
        self.max_depth = int(max_depth)
        self._items: List[MutationBatch] = []
        self._lock = threading.Lock()
        self.submitted = 0
        self.rejected = 0
        #: malformed batches dropped at apply time (serving loop accounting)
        self.failed = 0
        self.applied_batches = 0
        self.coalesced_from = 0

    def submit(self, batch: MutationBatch) -> Union[bool, Rejection]:
        """Queue one mutation batch, or reject with a retry hint when the
        backlog (typically: a long-running overlapped invocation is
        deferring ingest) is at capacity."""
        with self._lock:
            depth = len(self._items)
            if depth >= self.max_depth:
                self.rejected += 1
                return Rejection(retry_after_s=0.01 * depth,
                                 queue_depth=depth, reason="ingest_full")
            self._items.append(batch)
            self.submitted += 1
            return True

    def drain(self) -> List[MutationBatch]:
        """Remove everything pending and return it coalesced (FIFO order)."""
        return [merged for merged, _ in self.drain_groups()]

    def drain_groups(self) -> List[Tuple[MutationBatch, List[MutationBatch]]]:
        """Like :meth:`drain`, but each coalesced batch comes with its
        original member batches (the serving loop's fallback unit when a
        fold fails validation)."""
        with self._lock:
            items = self._items
            self._items = []
        out = coalesce_groups(items)
        self.coalesced_from += len(items)
        self.applied_batches += len(out)
        return out

    def depth(self) -> int:
        with self._lock:
            return len(self._items)
