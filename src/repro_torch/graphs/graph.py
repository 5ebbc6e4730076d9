"""Labelled graph container with a versioned mutation/delta model.

The graph is stored once on the host as numpy arrays (CSR + symmetric edge
list) and handed to the device as int32/float32 tensors.  All TAPER
computations are expressed over the *directed, symmetrised* edge list
``(src[i], dst[i])`` — an undirected edge appears in both directions, which
matches the paper's traversal semantics (Gremlin ``both()`` steps).

Dynamic graphs (online TAPER): :meth:`LabelledGraph.apply_mutations` applies
a batched :class:`MutationBatch` of edge/vertex insertions, deletions and
relabels *in place*, merge-patching the sorted edge arrays, ``row_ptr``, the
cached ``reverse_edge_index``, the cached neighbour-label count matrix and
any cached ``vm_packing`` entries, bitwise as the JAX package does.  The
dst-sorted CSR the ``vm_step`` kernel reads (:meth:`LabelledGraph.vm_csr`)
is dropped and re-derived from the patched packing on next use, row plan
included.  Every effective batch bumps :attr:`LabelledGraph.version`;
consumers holding graph-derived state (the device buffers in
``repro_torch.core.visitor``, the executor's traversal-count cache) compare
their recorded version against the graph's to detect staleness, and a
bounded :attr:`mutation_log` of :class:`AppliedMutation` records lets them
patch their own state incrementally.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.registry import BUILD_BUCKETS, default_registry

#: host seconds of the graph build's stages (``from_undirected_edges``; a
#: ``vm_csr`` that builds, its packing and row plan included)
_EDGES_BUILD, _CSR_BUILD = (
    default_registry().histogram("graph_build_seconds", buckets=BUILD_BUCKETS, stage=stage)
    for stage in ("edges", "csr"))


@dataclass
class MutationBatch:
    """A batch of topology mutations, expressed over *undirected* edges.

    Attributes:
      add_vertex_labels: label ids of brand-new vertices; they receive the
        next ``len(add_vertex_labels)`` vertex ids (``n .. n+v-1``) and may
        be referenced by ``add_edges`` in the same batch.
      add_edges: ``(e, 2)`` undirected edges to insert.  Self loops,
        already-present edges and edges touching a vertex removed in the
        same batch are dropped; an endpoint beyond the post-batch vertex
        range raises ``ValueError``.
      remove_edges: ``(e, 2)`` undirected edges to delete (absent edges are
        ignored).
      remove_vertices: vertex ids to delete.  Deletion *isolates* the vertex
        — all incident edges are dropped but the id slot and its label
        remain (a tombstone), so existing vertex ids, partition vectors and
        per-vertex caches never need renumbering.
      relabel: ``(v, new_label)`` pairs re-labelling existing vertices (same-
        batch additions included).  A vertex listed twice keeps the last
        entry.  Relabels are applied *after* the structural changes, against
        the post-batch adjacency.

    Removals are applied before additions: an edge listed in both ends up
    present.
    """

    add_vertex_labels: Sequence[int] = ()
    add_edges: Sequence = ()
    remove_edges: Sequence = ()
    remove_vertices: Sequence[int] = ()
    relabel: Sequence = ()

    @property
    def is_empty(self) -> bool:
        return not (
            len(self.add_vertex_labels)
            or len(self.add_edges)
            or len(self.remove_edges)
            or len(self.remove_vertices)
            or len(self.relabel)
        )


@dataclass
class AppliedMutation:
    """Normalised record of one applied :class:`MutationBatch`.

    All edge arrays are *directed* (symmetrised) and describe what actually
    changed.  ``old2new`` maps every pre-mutation edge position to its
    post-mutation position (``-1`` if the edge was removed) and
    ``new_edge_pos`` lists the post-mutation positions of inserted edges —
    together they let downstream per-edge state (e.g. the executor's
    traversal counts) be re-indexed without re-deriving the merge.
    """

    version: int            # graph version after applying (a no-op batch
                            # leaves it at the pre-call version; see is_noop)
    n_before: int
    n_after: int
    added_src: np.ndarray   # (a,) int32 directed
    added_dst: np.ndarray   # (a,) int32
    removed_src: np.ndarray  # (r,) int32 directed
    removed_dst: np.ndarray  # (r,) int32
    old2new: np.ndarray     # (m_before,) int64, -1 where removed
    new_edge_pos: np.ndarray  # (a,) int64 positions of added edges (new order)
    #: graph version the record's *pre* state corresponds to.  A freshly
    #: applied batch spans one version (``version - 1 -> version``); log
    #: compaction composes adjacent records into wider spans.
    version_base: int = -1
    #: effective vertex re-labellings: ``relabel_v[i]`` changed from
    #: ``relabel_old[i]`` to ``relabel_new[i]`` (old != new by construction)
    relabel_v: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    relabel_old: np.ndarray = field(
        default_factory=lambda: np.empty(0, np.int32))
    relabel_new: np.ndarray = field(
        default_factory=lambda: np.empty(0, np.int32))

    def __post_init__(self):
        if self.version_base < 0:
            self.version_base = self.version - 1

    @property
    def is_noop(self) -> bool:
        return (
            self.n_before == self.n_after
            and self.added_src.size == 0
            and self.removed_src.size == 0
            and self.relabel_v.size == 0
        )

    def dirty_vertices(self) -> np.ndarray:
        """Unique vertex ids whose incident edge set or label changed (plus
        brand-new vertices) — the seed frontier for mutation-local TAPER
        invocations."""
        parts = [
            self.added_src.astype(np.int64),
            self.added_dst.astype(np.int64),
            self.removed_src.astype(np.int64),
            self.removed_dst.astype(np.int64),
            self.relabel_v.astype(np.int64),
            np.arange(self.n_before, self.n_after, dtype=np.int64),
        ]
        return np.unique(np.concatenate(parts))


def compose_mutations(a: AppliedMutation, b: AppliedMutation) -> AppliedMutation:
    """Compose two *adjacent* records into one spanning both mutations.

    Requires ``b.version_base == a.version`` (b applies directly on top of
    a).  The composed ``old2new`` and ``new_edge_pos`` are exact.  The
    added/removed endpoint lists stay *bounded*: edges that are transient
    within the span (added by ``a`` then removed by ``b``) are pruned from
    both sides, so repeated churn over the same edge never accumulates —
    list sizes are bounded by the distinct edge universe, not by lifetime
    batch count.  An edge removed by ``a`` and re-added by ``b`` keeps both
    entries (a conservative dirty-seed superset; consumers re-derive
    against the final arrays, so extra seeds cost time, never correctness).
    """
    if b.version_base != a.version:
        raise ValueError(
            f"cannot compose: records not adjacent "
            f"({a.version_base}->{a.version} then {b.version_base}->{b.version})")
    valid = a.old2new >= 0
    old2new = np.full(a.old2new.shape[0], -1, dtype=np.int64)
    old2new[valid] = b.old2new[a.old2new[valid]]
    # a's added edges that survive b, re-indexed into b's final order
    a_pos_new = (b.old2new[a.new_edge_pos]
                 if a.new_edge_pos.size else a.new_edge_pos)
    surv = a_pos_new >= 0
    added_src = np.concatenate([a.added_src[surv], b.added_src])
    added_dst = np.concatenate([a.added_dst[surv], b.added_dst])
    new_edge_pos = np.concatenate([a_pos_new[surv], b.new_edge_pos])
    order = np.argsort(new_edge_pos, kind="stable")
    # prune b-removals of edges a itself added (transient within the span:
    # absent at the base, absent at the end — they are not removals w.r.t.
    # the composed pre-state, and dropping them is what keeps compacted
    # records from growing with every churn cycle over the same edge)
    span = np.int64(max(b.n_after, 1))
    b_rem_keys = b.removed_src.astype(np.int64) * span + b.removed_dst
    a_add_keys = np.unique(
        a.added_src.astype(np.int64) * span + a.added_dst)
    genuine = ~np.isin(b_rem_keys, a_add_keys)
    # relabels compose pointwise: earliest old, latest new; a net no-change
    # flip (a: x->y then b: y->x) is pruned — consumers re-derive against
    # the final labels, so the intermediate value never matters
    rl: Dict[int, Tuple[int, int]] = {}
    for rec in (a, b):
        for v, o, nw in zip(rec.relabel_v.tolist(),
                            rec.relabel_old.tolist(),
                            rec.relabel_new.tolist()):
            rl[v] = (rl[v][0], nw) if v in rl else (o, nw)
    rl_items = sorted((v, o, nw) for v, (o, nw) in rl.items() if o != nw)
    return AppliedMutation(
        version=b.version,
        n_before=a.n_before,
        n_after=b.n_after,
        added_src=added_src[order].astype(np.int32),
        added_dst=added_dst[order].astype(np.int32),
        removed_src=np.concatenate([a.removed_src, b.removed_src[genuine]]),
        removed_dst=np.concatenate([a.removed_dst, b.removed_dst[genuine]]),
        old2new=old2new,
        new_edge_pos=new_edge_pos[order],
        version_base=a.version_base,
        relabel_v=np.asarray([v for v, _, _ in rl_items], np.int64),
        relabel_old=np.asarray([o for _, o, _ in rl_items], np.int32),
        relabel_new=np.asarray([nw for _, _, nw in rl_items], np.int32),
    )


#: AppliedMutation array fields persisted by the mutation-log serializers,
#: with their storage dtypes (scalar fields travel in the manifest instead)
_MUTATION_ARRAY_FIELDS = (
    ("added_src", np.int32), ("added_dst", np.int32),
    ("removed_src", np.int32), ("removed_dst", np.int32),
    ("old2new", np.int64), ("new_edge_pos", np.int64),
    ("relabel_v", np.int64), ("relabel_old", np.int32),
    ("relabel_new", np.int32),
)


def mutation_log_state(log: Sequence[AppliedMutation]):
    """Flatten a mutation log for persistence: ``(arrays, meta)`` where
    ``arrays`` maps ``mlog{i}_{field}`` to the i-th record's edge/relabel
    arrays (npz-friendly) and ``meta`` holds each record's scalar version
    span — so a restored graph keeps the compacted log and its version
    spans, and slow consumers (executor DP patching) span-walk across the
    restart exactly as they would across any other gap."""
    arrays: Dict[str, np.ndarray] = {}
    meta = []
    for i, rec in enumerate(log):
        for name, dt in _MUTATION_ARRAY_FIELDS:
            arrays[f"mlog{i}_{name}"] = np.asarray(getattr(rec, name), dt)
        meta.append({
            "version": int(rec.version),
            "version_base": int(rec.version_base),
            "n_before": int(rec.n_before),
            "n_after": int(rec.n_after),
        })
    return arrays, meta


def mutation_log_from_state(arrays, meta) -> List[AppliedMutation]:
    """Inverse of :func:`mutation_log_state`."""
    out: List[AppliedMutation] = []
    for i, m in enumerate(meta):
        fields = {
            name: np.asarray(arrays[f"mlog{i}_{name}"], dt)
            for name, dt in _MUTATION_ARRAY_FIELDS
        }
        out.append(AppliedMutation(
            version=int(m["version"]),
            n_before=int(m["n_before"]),
            n_after=int(m["n_after"]),
            version_base=int(m["version_base"]),
            **fields,
        ))
    return out


@dataclass
class LabelledGraph:
    """A vertex-labelled graph ``G = (V, E, L_V, l)``.

    Attributes:
      n: number of vertices.
      labels: ``(n,)`` int32 — label id per vertex.
      label_names: label id -> human readable name.
      src, dst: ``(m,)`` int32 symmetric directed edge list, sorted by
        ``(src, dst)``.
      row_ptr: ``(n+1,)`` int64 CSR offsets into ``dst`` for each ``src``.
      version: mutation counter — bumped by every effective
        :meth:`apply_mutations`; lets derived caches detect staleness.
    """

    #: ring size of the mutation log.  When a new record would overflow it,
    #: the two oldest records are *composed* (``compose_mutations``) rather
    #: than dropped, so the log always reaches back to its earliest base
    #: version and slow consumers patch across arbitrarily long gaps —
    #: falling back to rebuild only when their snapshot predates that base
    #: or falls strictly inside a compacted span.
    MUTATION_LOG_LIMIT = 16

    n: int
    labels: np.ndarray
    label_names: List[str]
    src: np.ndarray
    dst: np.ndarray
    row_ptr: np.ndarray = field(repr=False, default=None)
    version: int = 0
    _rev_index: Optional[np.ndarray] = field(repr=False, default=None, compare=False)
    _vm_pack_cache: Dict = field(repr=False, default_factory=dict, compare=False)
    _mutation_log: List[AppliedMutation] = field(
        repr=False, default_factory=list, compare=False)

    def __post_init__(self):
        self.labels = np.asarray(self.labels, dtype=np.int32)
        self.src = np.asarray(self.src, dtype=np.int32)
        self.dst = np.asarray(self.dst, dtype=np.int32)
        if self.row_ptr is None:
            order = np.lexsort((self.dst, self.src))
            self.src = self.src[order]
            self.dst = self.dst[order]
            counts = np.bincount(self.src, minlength=self.n)
            self.row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

    # -- construction -----------------------------------------------------
    @staticmethod
    def from_undirected_edges(
        n: int,
        labels: Sequence[int],
        edges: np.ndarray,
        label_names: Optional[List[str]] = None,
        dedup: bool = True,
    ) -> "LabelledGraph":
        """Build from an ``(e, 2)`` array of undirected edges (no self loops);
        its host seconds go to ``graph_build_seconds{stage="edges"}``."""
        t0 = time.perf_counter()
        edges = np.asarray(edges, dtype=np.int64)
        if edges.size == 0:
            edges = edges.reshape(0, 2)
        keep = edges[:, 0] != edges[:, 1]  # paper fn.6: no self loops
        edges = edges[keep]
        labels = np.asarray(labels, dtype=np.int32)
        if label_names is None:
            label_names = [f"L{i}" for i in range(int(labels.max(initial=-1)) + 1)]
        if dedup:
            # the distinct keys src * n + dst in ascending order are the
            # (src, dst)-sorted edge list itself: no lexsort, and row_ptr
            # from the sources' counts.  Sorted and cut by hand: numpy 2's
            # np.unique of integers hashes, minutes for ~5e7 keys
            key = np.concatenate([edges[:, 0] * np.int64(n) + edges[:, 1],
                                  edges[:, 1] * np.int64(n) + edges[:, 0]])
            key.sort()
            if key.size:
                key = key[np.concatenate([[True], key[1:] != key[:-1]])]
            src = key // np.int64(max(n, 1))
            counts = np.bincount(src, minlength=n)
            g = LabelledGraph(
                n=n, labels=labels, label_names=list(label_names),
                src=src.astype(np.int32), dst=(key - src * n).astype(np.int32),
                row_ptr=np.concatenate([[0], np.cumsum(counts)]).astype(np.int64))
        else:
            sym = np.concatenate([edges, edges[:, ::-1]], axis=0)
            g = LabelledGraph(
                n=n,
                labels=labels,
                label_names=list(label_names),
                src=sym[:, 0].astype(np.int32),
                dst=sym[:, 1].astype(np.int32),
            )
        _EDGES_BUILD.observe(time.perf_counter() - t0)
        return g

    def copy(self) -> "LabelledGraph":
        """Independent copy with fresh (empty) caches and version 0."""
        return LabelledGraph(
            n=self.n,
            labels=self.labels.copy(),
            label_names=list(self.label_names),
            src=self.src.copy(),
            dst=self.dst.copy(),
            row_ptr=self.row_ptr.copy(),
        )

    # -- properties --------------------------------------------------------
    @property
    def m(self) -> int:
        """Number of *directed* edges (2x undirected count)."""
        return int(self.src.shape[0])

    @property
    def n_labels(self) -> int:
        return len(self.label_names)

    @property
    def degrees(self) -> np.ndarray:
        return (self.row_ptr[1:] - self.row_ptr[:-1]).astype(np.int64)

    @property
    def mutation_log(self) -> List[AppliedMutation]:
        return self._mutation_log

    def neighbors(self, v: int) -> np.ndarray:
        return self.dst[self.row_ptr[v] : self.row_ptr[v + 1]]

    def edge_indices_of(self, vs: np.ndarray) -> np.ndarray:
        """Concatenated CSR edge indices of ``vs`` — each vertex's out-edges
        in CSR order, vertices in the given order."""
        vs = np.asarray(vs, dtype=np.int64)
        starts = self.row_ptr[vs]
        cnts = self.row_ptr[vs + 1] - starts
        total = int(cnts.sum())
        if total == 0:
            return np.empty(0, dtype=np.int64)
        offs = np.repeat(starts - (np.cumsum(cnts) - cnts), cnts)
        return offs + np.arange(total, dtype=np.int64)

    @property
    def reverse_edge_index(self) -> np.ndarray:
        """``(m,)`` int64 — index of the reverse edge ``(w, u)`` for each
        directed edge ``i = (u, w)``, or ``-1`` if absent.

        The edge list is sorted by ``(src, dst)``, so the flat keys
        ``src * n + dst`` are ascending and every reverse edge is found with
        one vectorised ``searchsorted`` — no per-edge host loops.  Cached on
        first use and *incrementally patched* by :meth:`apply_mutations`;
        symmetric graphs built via :meth:`from_undirected_edges` always
        yield a total (no ``-1``) mapping with ``rev[rev] == arange(m)``.
        """
        if self._rev_index is None:
            keys = self.src.astype(np.int64) * self.n + self.dst
            rkeys = self.dst.astype(np.int64) * self.n + self.src
            pos = np.searchsorted(keys, rkeys)
            pos = np.minimum(pos, max(self.m - 1, 0))
            found = (keys[pos] == rkeys) if self.m else np.zeros(0, bool)
            self._rev_index = np.where(found, pos, -1).astype(np.int64)
        return self._rev_index

    def is_symmetric(self) -> bool:
        """True when every directed edge has its reverse present."""
        return bool((self.reverse_edge_index >= 0).all()) if self.m else True

    def vm_packing(self, cnt: Optional[np.ndarray] = None,
                   block_n: int = 128, block_e: int = 256):
        """Cached block-padded edge packing (the JAX package's ``vm_step``
        layout, kept bitwise equal to it; the port's kernel reads the
        dst-sorted CSR of :meth:`vm_csr`, derived from this packing).

        Returns ``(packed, dst_label, inv_cnt, dst_global)`` where the first
        three follow :func:`repro_torch.kernels.vm_step.ops.pack_vm_inputs` and
        ``dst_global`` is the ``(E_pad,)`` global destination id per packed
        slot.  Padding slots alias the first vertex of their block
        (``dst_local == 0``, i.e. ``block_id * block_n``) — use
        ``packed.pad_mask``, not ``dst_global``, to identify padding; the
        zeroed ``inv_cnt`` channel is what neutralises padded slots in the
        kernel.  The packing depends only on the graph (not on
        any partitioning), so it is computed once and reused across every
        extroversion-field evaluation/iteration; :meth:`apply_mutations`
        merge-patches cached entries block-by-block instead of re-packing.
        A non-default ``cnt`` is checked against the cached one — a mismatch
        rebuilds rather than silently returning channels derived from a
        different count matrix.
        """
        # normalise first so a cnt=None call never aliases an entry built
        # from a custom count matrix (the graph's own counts are cached too)
        if cnt is None:
            cnt = self.cached_neighbor_label_counts()
        key = (int(block_n), int(block_e))
        hit = self._vm_pack_cache.get(key)
        if hit is not None:
            cached_cnt, entry = hit
            if cached_cnt is cnt or np.array_equal(cnt, cached_cnt):
                return entry
        from repro_torch.kernels.vm_step.ops import pack_vm_inputs

        packed, dst_label, inv_cnt = pack_vm_inputs(
            self.src, self.dst, self.labels, cnt, self.n,
            block_n=block_n, block_e=block_e)
        dst_global = (np.repeat(packed.meta[:, 0], packed.block_e)
                      * packed.block_n) + packed.dst_local
        entry = (packed, dst_label, inv_cnt, dst_global.astype(np.int32))
        self._vm_pack_cache[key] = (np.asarray(cnt), entry)
        return entry

    def vm_csr(self):
        """Cached dst-sorted CSR for the port's ``vm_step`` kernel.

        Derived from :meth:`vm_packing`'s stable destination sort
        (``PackedEdges.order``), so within each destination row the edges
        keep ascending source order — the order in which the reference
        scatter-adds them.  Returns a
        :class:`repro_torch.kernels.segment_spmm.ops.EdgeCSR` (row offsets, source
        ids and the edge-list index of each slot, with its row plan); it
        depends only on the graph, so it is built once per graph version:
        :meth:`apply_mutations` drops it, and the next call derives it from
        the patched packing, equal to a fresh graph's.  A build's host
        seconds go to ``graph_build_seconds{stage="csr"}``."""
        entry = self._vm_pack_cache.get("csr")
        if entry is None:
            from repro_torch.kernels.segment_spmm.ops import csr_from_packing

            t0 = time.perf_counter()
            packed, _, _, dst_global = self.vm_packing()
            entry = csr_from_packing(packed, dst_global, self.n)
            self._vm_pack_cache["csr"] = entry
            _CSR_BUILD.observe(time.perf_counter() - t0)
        return entry

    def vm_packing_sharded(self, n_shards: int,
                           cnt: Optional[np.ndarray] = None,
                           block_n: int = 128, block_e: int = 256,
                           order: Optional[np.ndarray] = None,
                           order_token: str = "stripe"):
        """Cached shard-aware edge packing for the sharded field.

        Returns a :class:`repro_torch.graphs.sharded_packing.ShardedVMPacking`:
        the ``vm_packing`` destination blocks dealt across ``n_shards``
        shards along the ``order`` shard map (a vertex -> position
        permutation; ``None`` = contiguous id stripes), with per-shard
        local/halo source index maps and both halo-exchange table sets (see
        that module's docstring).  Cached per ``(n_shards, block_n,
        block_e)`` and version-keyed like :meth:`vm_packing`; a call with a
        different ``order_token`` re-deals (rebuilds) the cached entry.
        :meth:`apply_mutations` patches cached entries per dirty shard
        (bumping their ``shard_epoch`` counters so device caches re-upload
        only changed shard slices), evicting only when the mutation
        outgrows the packing's capacity slack.
        """
        if cnt is None:
            cnt = self.cached_neighbor_label_counts()
        key = ("sharded", int(n_shards), int(block_n), int(block_e))
        hit = self._vm_pack_cache.get(key)
        if hit is not None:
            cached_cnt, entry = hit
            if (entry.version == self.version
                    and entry.order_token == order_token
                    and (cached_cnt is cnt or np.array_equal(cnt, cached_cnt))):
                return entry
        from repro_torch.graphs.sharded_packing import build_sharded_vm_packing

        entry = build_sharded_vm_packing(
            self, n_shards, cnt, block_n=block_n, block_e=block_e,
            order=order, order_token=order_token)
        self._vm_pack_cache[key] = (np.asarray(cnt), entry)
        return entry

    def label_counts(self) -> np.ndarray:
        """(n_labels,) number of vertices per label."""
        return np.bincount(self.labels, minlength=self.n_labels)

    def neighbor_label_counts(self) -> np.ndarray:
        """(n, n_labels) int32 — ``cnt[u, l]`` neighbours of u with label l."""
        flat = self.src.astype(np.int64) * self.n_labels + self.labels[self.dst]
        cnt = np.bincount(flat, minlength=self.n * self.n_labels)
        return cnt.reshape(self.n, self.n_labels).astype(np.int32)

    def cached_neighbor_label_counts(self) -> np.ndarray:
        """The graph's own neighbour-label count matrix, built lazily and
        incrementally patched across mutations (treat as read-only)."""
        cnt = self._vm_pack_cache.get("_default_cnt")
        if cnt is None:
            cnt = self.neighbor_label_counts()
            self._vm_pack_cache["_default_cnt"] = cnt
        return cnt

    def undirected_edge_count(self) -> int:
        return self.m // 2

    # -- mutation ----------------------------------------------------------
    def apply_mutations(self, batch: MutationBatch) -> AppliedMutation:
        """Apply a :class:`MutationBatch` in place; return the normalised
        :class:`AppliedMutation` record.

        The sorted edge arrays are *merge-patched*: removals become a keep
        mask, additions are merged by one ``searchsorted`` pass — no
        re-sort.  ``row_ptr`` is rebuilt from patched degree counts (O(n)),
        and the cached ``reverse_edge_index``, neighbour-label counts and
        ``vm_packing`` entries are patched rather than recomputed; the
        cached :meth:`vm_csr` is dropped (the next call re-derives it from
        the patched packing).  Bumps
        :attr:`version` and appends to :attr:`mutation_log` unless the batch
        turns out to be a no-op.
        """
        n_old, m_old = self.n, self.m
        L = self.n_labels

        new_labels = np.asarray(
            batch.add_vertex_labels, dtype=np.int32).reshape(-1)
        if new_labels.size and (
                new_labels.min() < 0 or new_labels.max() >= L):
            raise ValueError("add_vertex_labels out of label range")
        n_new = n_old + int(new_labels.size)
        labels_new = (np.concatenate([self.labels, new_labels])
                      if new_labels.size else self.labels)

        # ---- relabels (validated now, applied after structural changes) --
        rl = np.asarray(batch.relabel, dtype=np.int64).reshape(-1, 2)
        if rl.size:
            if rl[:, 0].min() < 0 or rl[:, 0].max() >= n_new:
                raise ValueError("relabel vertex id out of range")
            if rl[:, 1].min() < 0 or rl[:, 1].max() >= L:
                raise ValueError("relabel label out of label range")
            # a vertex listed twice keeps its last entry
            _, last = np.unique(rl[::-1, 0], return_index=True)
            rl = rl[rl.shape[0] - 1 - last]
            eff = labels_new[rl[:, 0]] != rl[:, 1]
            rl = rl[eff]
        rl_v = rl[:, 0] if rl.size else np.empty(0, np.int64)
        rl_new_lab = rl[:, 1].astype(np.int32) if rl.size else \
            np.empty(0, np.int32)
        rl_old_lab = labels_new[rl_v].astype(np.int32) if rl.size else \
            np.empty(0, np.int32)

        keys_old = self.src.astype(np.int64) * n_new + self.dst
        if m_old > 1 and not (np.diff(keys_old) > 0).all():
            raise ValueError(
                "apply_mutations requires a deduplicated (src, dst)-sorted "
                "edge list")

        # ---- removals -> keep mask over old edge positions ---------------
        removed_vs = (np.unique(np.asarray(
            batch.remove_vertices, dtype=np.int64).reshape(-1))
            if len(batch.remove_vertices) else np.empty(0, np.int64))
        if removed_vs.size and (
                removed_vs.min() < 0 or removed_vs.max() >= n_new):
            raise ValueError("remove_vertices out of range")

        rem = np.asarray(batch.remove_edges, dtype=np.int64).reshape(-1, 2)
        rem_dir = (np.concatenate([rem, rem[:, ::-1]], axis=0)
                   if rem.size else rem.reshape(0, 2))
        old_removed_vs = removed_vs[removed_vs < n_old]
        if old_removed_vs.size:
            # collect out- AND in-arcs explicitly: on an asymmetric graph a
            # one-directional in-arc has no stored reverse, so mirroring the
            # out-edges would leave it dangling on the tombstone
            out_e = self.edge_indices_of(old_removed_vs)
            in_e = np.nonzero(np.isin(self.dst, old_removed_vs))[0]
            eidx = np.unique(np.concatenate([out_e, in_e]))
            inc = np.stack(
                [self.src[eidx], self.dst[eidx]], axis=1).astype(np.int64)
            rem_dir = np.concatenate([rem_dir, inc], axis=0)
        removed_pos = np.empty(0, np.int64)
        if rem_dir.size:
            ok = ((rem_dir >= 0) & (rem_dir < n_new)).all(axis=1)
            rem_dir = rem_dir[ok]
            rem_keys = np.unique(rem_dir[:, 0] * n_new + rem_dir[:, 1])
            if m_old:
                pos = np.minimum(
                    np.searchsorted(keys_old, rem_keys), m_old - 1)
                removed_pos = np.unique(pos[keys_old[pos] == rem_keys])
        keep = np.ones(m_old, dtype=bool)
        keep[removed_pos] = False
        kept_idx = np.nonzero(keep)[0]
        kept_keys = keys_old[kept_idx]

        # ---- additions -> sorted, deduped, not-already-present -----------
        add = np.asarray(batch.add_edges, dtype=np.int64).reshape(-1, 2)
        if add.size:
            if (add < 0).any() or (add >= n_new).any():
                raise ValueError(
                    "add_edges endpoint out of range (did the batch forget "
                    "matching add_vertex_labels?)")
            ok = add[:, 0] != add[:, 1]
            if removed_vs.size:
                ok &= ~(np.isin(add[:, 0], removed_vs)
                        | np.isin(add[:, 1], removed_vs))
            add = add[ok]
        add_dir = (np.concatenate([add, add[:, ::-1]], axis=0)
                   if add.size else add.reshape(0, 2))
        add_keys = (np.unique(add_dir[:, 0] * n_new + add_dir[:, 1])
                    if add_dir.size else np.empty(0, np.int64))
        if add_keys.size and kept_keys.size:
            p = np.minimum(
                np.searchsorted(kept_keys, add_keys), kept_keys.size - 1)
            add_keys = add_keys[kept_keys[p] != add_keys]
        add_s, add_d = np.divmod(add_keys, n_new)
        a = int(add_keys.size)

        if (a == 0 and removed_pos.size == 0 and n_new == n_old
                and rl_v.size == 0):
            # no effective change: no version bump, no log entry
            return AppliedMutation(
                version=self.version, n_before=n_old, n_after=n_old,
                added_src=np.empty(0, np.int32),
                added_dst=np.empty(0, np.int32),
                removed_src=np.empty(0, np.int32),
                removed_dst=np.empty(0, np.int32),
                old2new=np.arange(m_old, dtype=np.int64),
                new_edge_pos=np.empty(0, np.int64),
                version_base=self.version,
            )

        # ---- merge kept + added (one searchsorted, no re-sort) -----------
        m_new = kept_idx.size + a
        shift = np.searchsorted(add_keys, kept_keys)   # added keys before kept
        new_pos_kept = np.arange(kept_idx.size, dtype=np.int64) + shift
        new_pos_added = (np.searchsorted(kept_keys, add_keys)
                         + np.arange(a, dtype=np.int64))
        src_new = np.empty(m_new, dtype=np.int32)
        dst_new = np.empty(m_new, dtype=np.int32)
        src_new[new_pos_kept] = self.src[kept_idx]
        dst_new[new_pos_kept] = self.dst[kept_idx]
        src_new[new_pos_added] = add_s.astype(np.int32)
        dst_new[new_pos_added] = add_d.astype(np.int32)
        old2new = np.full(m_old, -1, dtype=np.int64)
        old2new[kept_idx] = new_pos_kept

        removed_src = self.src[removed_pos].copy()
        removed_dst = self.dst[removed_pos].copy()

        # ---- row_ptr from patched degrees (O(n) cumsum) ------------------
        deg = (self.row_ptr[1:] - self.row_ptr[:-1]).astype(np.int64)
        if n_new > n_old:
            deg = np.concatenate([deg, np.zeros(n_new - n_old, np.int64)])
        if removed_pos.size:
            deg -= np.bincount(removed_src, minlength=n_new)[:n_new]
        if a:
            deg += np.bincount(add_s, minlength=n_new)[:n_new]
        row_ptr_new = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)

        # ---- patch cached reverse_edge_index -----------------------------
        rev_new = None
        if self._rev_index is not None:
            rev_old = self._rev_index
            rev_new = np.full(m_new, -1, dtype=np.int64)
            r = rev_old[kept_idx]
            ok = (r >= 0) & keep[np.minimum(np.maximum(r, 0), max(m_old - 1, 0))]
            rev_new[new_pos_kept[ok]] = old2new[r[ok]]
            # kept edges whose reverse vanished/appeared + all added edges
            need = np.concatenate([new_pos_kept[~ok], new_pos_added])
            if need.size and m_new:
                keys_new = src_new.astype(np.int64) * n_new + dst_new
                rk = dst_new[need].astype(np.int64) * n_new + src_new[need]
                p = np.minimum(np.searchsorted(keys_new, rk), m_new - 1)
                rev_new[need] = np.where(keys_new[p] == rk, p, -1)

        # ---- patch cached neighbour-label counts -------------------------
        cnt_old = self._vm_pack_cache.get("_default_cnt")
        cnt_new = None
        if cnt_old is not None:
            if n_new > n_old:
                cnt_new = np.concatenate(
                    [cnt_old, np.zeros((n_new - n_old, L), cnt_old.dtype)])
            else:
                cnt_new = cnt_old.copy()
            if removed_pos.size:
                np.subtract.at(
                    cnt_new,
                    (removed_src.astype(np.int64),
                     labels_new[removed_dst.astype(np.int64)]), 1)
            if a:
                np.add.at(cnt_new, (add_s, labels_new[add_d]), 1)

        # ---- apply relabels against the post-batch adjacency -------------
        # structural count updates above used the pre-relabel labels; the
        # relabel delta now shifts each re-labelled vertex's final in-edge
        # contributions old->new, which composes exactly (a same-batch added
        # edge lands at the old column first, then shifts here)
        labels_final = labels_new
        rl_in_src = np.empty(0, np.int64)   # sources of final in-edges of rl_v
        rl_in_old = np.empty(0, np.int32)
        rl_in_new = np.empty(0, np.int32)
        if rl_v.size:
            labels_final = labels_new.copy()
            labels_final[rl_v] = rl_new_lab
            old_of = np.full(n_new, -1, np.int32)
            new_of = np.full(n_new, -1, np.int32)
            old_of[rl_v] = rl_old_lab
            new_of[rl_v] = rl_new_lab
            # in-edges of the re-labelled vertices: O(deg) through the
            # patched reverse index when the graph is symmetric (the
            # serving ingest hot path), O(m) dst scan otherwise
            sel = None
            if rev_new is not None and (
                    bool((rev_new >= 0).all()) if m_new else True):
                starts = row_ptr_new[rl_v]
                cnts = row_ptr_new[rl_v + 1] - starts
                total = int(cnts.sum())
                if total:
                    offs = np.repeat(
                        starts - (np.cumsum(cnts) - cnts), cnts)
                    sel = rev_new[offs + np.arange(total, dtype=np.int64)]
                else:
                    sel = np.empty(0, np.int64)
            if sel is None:
                sel = np.nonzero(np.isin(dst_new, rl_v))[0]
            rl_in_src = src_new[sel].astype(np.int64)
            rl_in_old = old_of[dst_new[sel]]
            rl_in_new = new_of[dst_new[sel]]
            if cnt_new is not None and sel.size:
                np.subtract.at(cnt_new, (rl_in_src, rl_in_old), 1)
                np.add.at(cnt_new, (rl_in_src, rl_in_new), 1)

        # ---- patch cached vm_packing entries (block merge-patch) ---------
        changed_dsts = np.unique(np.concatenate(
            [removed_dst.astype(np.int64), add_d, rl_v]))
        changed_pairs = np.unique(np.concatenate([
            removed_src.astype(np.int64) * L
            + labels_new[removed_dst.astype(np.int64)],
            add_s * L + labels_new[add_d],
            rl_in_src * L + rl_in_old,
            rl_in_src * L + rl_in_new,
        ]))
        # a cached entry is patchable when it was built from the graph's own
        # counts and the patched graph is symmetric; others (custom cnt, an
        # asymmetric graph) are evicted and rebuilt lazily on next use
        patchable = (
            cnt_new is not None
            and rev_new is not None
            and bool((rev_new >= 0).all() if m_new else True)
        )
        patched_entries = {}
        sharded_items = []
        for key, hit in self._vm_pack_cache.items():
            kind = self._cache_kind(key)
            if kind in ("counts", "csr"):
                # the graph's counts are patched above; the dst-sorted CSR
                # is dropped and re-derived from the patched packing
                continue
            cached_cnt, entry = hit
            if not (patchable and (cached_cnt is cnt_old
                                   or np.array_equal(cached_cnt, cnt_old))):
                continue
            if kind == "sharded":
                # patched per dirty shard once the new arrays are committed
                sharded_items.append((key, entry))
            else:
                patched_entries[key] = (cnt_new, self._patch_vm_entry(
                    key, entry, src_new, dst_new, row_ptr_new, labels_final,
                    cnt_new, rev_new, n_new, changed_dsts, changed_pairs))

        # ---- commit ------------------------------------------------------
        self.n = n_new
        self.labels = labels_final
        self.src = src_new
        self.dst = dst_new
        self.row_ptr = row_ptr_new
        self._rev_index = rev_new
        self._vm_pack_cache = patched_entries
        if cnt_new is not None:
            self._vm_pack_cache["_default_cnt"] = cnt_new
        self.version += 1

        # ---- patch cached sharded packings (dirty shards only) -----------
        if sharded_items:
            from repro_torch.graphs.sharded_packing import patch_sharded_vm_packing

            for key, entry in sharded_items:
                if patch_sharded_vm_packing(entry, self, cnt_new, changed_dsts,
                                            changed_pairs, n_old, old2new):
                    self._vm_pack_cache[key] = (cnt_new, entry)
                # capacity overflow: the entry stays evicted and is rebuilt
                # from scratch on the next vm_packing_sharded call

        applied = AppliedMutation(
            version=self.version,
            n_before=n_old,
            n_after=n_new,
            added_src=add_s.astype(np.int32),
            added_dst=add_d.astype(np.int32),
            removed_src=removed_src,
            removed_dst=removed_dst,
            old2new=old2new,
            new_edge_pos=new_pos_added,
            relabel_v=rl_v.copy(),
            relabel_old=rl_old_lab,
            relabel_new=rl_new_lab,
        )
        self._mutation_log.append(applied)
        while len(self._mutation_log) > self.MUTATION_LOG_LIMIT:
            # ring compaction: instead of dropping the oldest record (which
            # would strand slow consumers on a rebuild), compose the two
            # oldest into one wider-span record — old2new maps compose
            # eagerly, so a consumer at the span's base still patches
            self._mutation_log[:2] = [
                compose_mutations(self._mutation_log[0],
                                  self._mutation_log[1])]
        return applied

    @staticmethod
    def _cache_kind(key) -> str:
        """The kind of a ``_vm_pack_cache`` key: ``"counts"`` (the graph's
        own neighbour-label counts), ``"csr"`` (:meth:`vm_csr`),
        ``"sharded"`` (:meth:`vm_packing_sharded`) or ``"packing"``
        (:meth:`vm_packing`, keyed ``(block_n, block_e)``)."""
        if key == "_default_cnt":
            return "counts"
        if key == "csr":
            return "csr"
        if isinstance(key, tuple) and key and key[0] == "sharded":
            return "sharded"
        if (isinstance(key, tuple) and len(key) == 2
                and all(isinstance(v, int) for v in key)):
            return "packing"
        raise KeyError(f"unknown vm packing cache key {key!r}")

    def _patch_vm_entry(self, key, entry, src_new, dst_new, row_ptr_new,
                        labels_new, cnt_new, rev_new, n_new,
                        changed_dsts, changed_pairs):
        """Merge-patch one cached ``vm_packing`` entry.

        Exploits symmetry: the dst-sorted edge view that ``pack_edges``
        builds is exactly the swapped raw arrays (the j-th ``(dst, src)``
        pair in sorted order is the j-th raw ``(src, dst)`` pair with roles
        exchanged), and its sort permutation is the reverse-edge involution.
        Only dst-blocks containing a mutated endpoint are re-packed; the
        rest are copied slice-wise, with ``inv_cnt`` refreshed for slots
        whose ``(src, dst-label)`` count changed.
        """
        bn, be = key
        packed_old, dst_label_old, inv_cnt_old, _ = entry
        nb_old = packed_old.n_blocks_out
        nb_new = (n_new + bn - 1) // bn

        aff = np.unique(np.concatenate([
            changed_dsts // bn, np.arange(nb_old, nb_new, dtype=np.int64)]))
        aff = aff[aff < nb_new]
        aff_mask = np.zeros(nb_new, dtype=bool)
        aff_mask[aff] = True

        old_eb = np.bincount(packed_old.meta[:, 0], minlength=nb_old)
        new_eb = np.zeros(nb_new, dtype=np.int64)
        new_eb[:min(nb_old, nb_new)] = old_eb[:min(nb_old, nb_new)]
        # per-block real edge counts from the new CSR (in-deg == out-deg)
        v_hi = np.minimum((aff + 1) * bn, n_new)
        blk_cnt = row_ptr_new[v_hi] - row_ptr_new[np.minimum(aff * bn, n_new)]
        new_eb[aff] = np.maximum(1, -(-blk_cnt // be))
        old_off = np.concatenate([[0], np.cumsum(old_eb)]) * be
        new_off = np.concatenate([[0], np.cumsum(new_eb)]) * be
        e_pad = int(new_off[-1])

        src_p = np.zeros(e_pad, dtype=np.int32)
        dloc_p = np.zeros(e_pad, dtype=np.int32)
        mask_p = np.zeros(e_pad, dtype=bool)
        dlab_p = np.zeros(e_pad, dtype=np.int32)
        inv_p = np.zeros(e_pad, dtype=np.float32)

        o_src = np.asarray(packed_old.src)
        o_dloc = np.asarray(packed_old.dst_local)
        o_mask = np.asarray(packed_old.pad_mask)
        o_dlab = np.asarray(dst_label_old)
        o_inv = np.asarray(inv_cnt_old)

        # copy runs of unaffected blocks wholesale
        b = 0
        while b < min(nb_old, nb_new):
            if aff_mask[b]:
                b += 1
                continue
            e = b
            while e < min(nb_old, nb_new) and not aff_mask[e]:
                e += 1
            slo, shi = int(old_off[b]), int(old_off[e])
            dlo = int(new_off[b])
            span = shi - slo
            src_p[dlo:dlo + span] = o_src[slo:shi]
            dloc_p[dlo:dlo + span] = o_dloc[slo:shi]
            mask_p[dlo:dlo + span] = o_mask[slo:shi]
            dlab_p[dlo:dlo + span] = o_dlab[slo:shi]
            inv_p[dlo:dlo + span] = o_inv[slo:shi]
            b = e

        # rebuild affected blocks from the swapped raw arrays
        for blk in aff.tolist():
            vlo, vhi_b = blk * bn, min((blk + 1) * bn, n_new)
            lo, hi = int(row_ptr_new[vlo]), int(row_ptr_new[vhi_b])
            c = hi - lo
            o = int(new_off[blk])
            if c:
                src_p[o:o + c] = dst_new[lo:hi]
                dloc_p[o:o + c] = src_new[lo:hi] - vlo
                mask_p[o:o + c] = True
                dlab_p[o:o + c] = labels_new[src_new[lo:hi]]
                inv_p[o:o + c] = 1.0 / np.maximum(
                    cnt_new[dst_new[lo:hi], labels_new[src_new[lo:hi]]], 1.0)

        # refresh inv_cnt where the (src, dst-label) count changed
        if changed_pairs.size:
            slot_keys = src_p.astype(np.int64) * self.n_labels + dlab_p
            upd = mask_p & np.isin(slot_keys, changed_pairs)
            if upd.any():
                inv_p[upd] = 1.0 / np.maximum(
                    cnt_new[src_p[upd], dlab_p[upd]], 1.0)

        meta = np.zeros((int(new_eb.sum()), 2), dtype=np.int32)
        meta[:, 0] = np.repeat(
            np.arange(nb_new, dtype=np.int64), new_eb).astype(np.int32)
        firsts = np.concatenate([[0], np.cumsum(new_eb)[:-1]])
        meta[firsts, 1] = 1

        from repro_torch.kernels.segment_spmm.ops import PackedEdges

        packed_new = PackedEdges(
            src=src_p, dst_local=dloc_p, meta=meta, pad_mask=mask_p,
            order=rev_new, n_blocks_out=int(nb_new), block_n=bn, block_e=be)
        dst_global = (np.repeat(meta[:, 0], be) * bn + dloc_p).astype(np.int32)
        return (packed_new, dlab_p, inv_p, dst_global)

    def subgraph_mask(self, vmask: np.ndarray) -> "LabelledGraph":
        """Induced subgraph on the vertices where ``vmask`` is True.

        Vertex ids are compacted; returns the subgraph (labels preserved).
        """
        idx = np.nonzero(vmask)[0]
        remap = -np.ones(self.n, dtype=np.int64)
        remap[idx] = np.arange(idx.size)
        emask = vmask[self.src] & vmask[self.dst]
        s, d = remap[self.src[emask]], remap[self.dst[emask]]
        return LabelledGraph(
            n=int(idx.size),
            labels=self.labels[idx],
            label_names=self.label_names,
            src=s.astype(np.int32),
            dst=d.astype(np.int32),
        )

    def validate(self) -> None:
        assert self.labels.shape == (self.n,)
        assert self.src.shape == self.dst.shape
        assert self.row_ptr.shape == (self.n + 1,)
        assert self.row_ptr[-1] == self.m
        if self.m:
            assert self.src.min() >= 0 and self.src.max() < self.n
            assert self.dst.min() >= 0 and self.dst.max() < self.n
        assert self.labels.min(initial=0) >= 0
        assert self.labels.max(initial=0) < self.n_labels

    def stats(self) -> Dict[str, float]:
        deg = self.degrees
        return {
            "n": self.n,
            "m_undirected": self.undirected_edge_count(),
            "n_labels": self.n_labels,
            "avg_degree": float(deg.mean()) if self.n else 0.0,
            "max_degree": int(deg.max()) if self.n else 0,
        }
