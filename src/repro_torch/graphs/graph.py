"""Labelled graph container (host-side numpy, CSR + symmetric edge list).

The graph is stored once on the host as numpy arrays and handed to the
device as int32/float32 tensors.  All TAPER computations are expressed over
the *directed, symmetrised* edge list ``(src[i], dst[i])`` — an undirected
edge appears in both directions, which matches the paper's traversal
semantics (Gremlin ``both()`` steps).

This is the static core of the JAX package's ``graphs/graph.py``; the
mutation model (``apply_mutations`` and its incremental cache patching)
belongs to the online slice of the port.  ``version`` stays 0 here and keys
the device-resident caches in ``repro_torch.core.visitor`` all the same.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np


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
      version: mutation counter; lets derived caches detect staleness.
    """

    n: int
    labels: np.ndarray
    label_names: List[str]
    src: np.ndarray
    dst: np.ndarray
    row_ptr: np.ndarray = field(repr=False, default=None)
    version: int = 0
    _rev_index: Optional[np.ndarray] = field(repr=False, default=None, compare=False)
    _vm_pack_cache: Dict = field(repr=False, default_factory=dict, compare=False)

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
        """Build from an ``(e, 2)`` array of undirected edges (no self loops)."""
        edges = np.asarray(edges, dtype=np.int64)
        if edges.size == 0:
            edges = edges.reshape(0, 2)
        keep = edges[:, 0] != edges[:, 1]  # paper fn.6: no self loops
        edges = edges[keep]
        sym = np.concatenate([edges, edges[:, ::-1]], axis=0)
        if dedup and len(sym):
            key = sym[:, 0] * np.int64(n) + sym[:, 1]
            _, idx = np.unique(key, return_index=True)
            sym = sym[idx]
        labels = np.asarray(labels, dtype=np.int32)
        if label_names is None:
            label_names = [f"L{i}" for i in range(int(labels.max(initial=-1)) + 1)]
        return LabelledGraph(
            n=n,
            labels=labels,
            label_names=list(label_names),
            src=sym[:, 0].astype(np.int32),
            dst=sym[:, 1].astype(np.int32),
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
        first use; symmetric graphs built via :meth:`from_undirected_edges` always
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
        extroversion-field evaluation/iteration.  A non-default ``cnt`` is
        checked against the cached one — a mismatch rebuilds rather than
        silently returning channels derived from a different count matrix.
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
        ids and the edge-list index of each slot); it depends only on the
        graph, so it is built once per graph."""
        entry = self._vm_pack_cache.get("csr")
        if entry is None:
            from repro_torch.kernels.segment_spmm.ops import csr_from_packing

            packed, _, _, dst_global = self.vm_packing()
            entry = csr_from_packing(packed, dst_global, self.n)
            self._vm_pack_cache["csr"] = entry
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
        (treat as read-only)."""
        cnt = self._vm_pack_cache.get("_default_cnt")
        if cnt is None:
            cnt = self.neighbor_label_counts()
            self._vm_pack_cache["_default_cnt"] = cnt
        return cnt

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
