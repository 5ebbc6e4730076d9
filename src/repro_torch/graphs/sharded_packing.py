"""Shard-aware edge packing for the sharded extroversion field.

Partitions the per-graph ``vm_packing`` destination blocks across the ranks
of a ``torch.distributed`` process group, so each rank runs the ``vm_step``
kernel over its own shard's *local* edges.  The arrays are bitwise those of
the JAX package's packer (same algorithm, numpy only); the exchange names
keep its vocabulary: ``"psum"`` is one ``all_reduce`` over the group, a
ring round one ``batch_isend_irecv``.

**Index spaces.**  The packing separates a vertex's *id* from its *position*
in the shard layout: a pluggable **shard map** (a vertex permutation
``pos_of``/``vtx_at``) decides where each vertex lives.  Shard ``s`` owns the
contiguous *position* range ``[s * n_local_pad, (s+1) * n_local_pad)``; which
vertices occupy those positions is the shard map's choice:

* ``"stripe"`` — identity (contiguous vertex-id ranges);
* ``"partition"`` — positions dealt along the live TAPER partition vector
  (k -> S folding via greedy largest-partition-first when k != n_shards), so
  co-partitioned — i.e. co-traversed — vertices co-locate on a shard;
* ``"bfs"`` — breadth-first visitation order from high-degree seeds, a
  community/locality ordering for graphs with no partition yet.

Kernel output rows are positions (a shard's destination blocks never cross
shards); what crosses shards is the *source* side of an edge: a shard's edge
blocks may read ``beta`` rows of vertices positioned elsewhere (the shard's
**halo**).  A topology-aware shard map makes halos small — TAPER's own
thesis (query-aware placement minimises cross-partition traversals) applied
to the compute layout.

**Halo exchange tables.**  The packing precomputes both exchange backends:

* ``frontier`` — the union of all shards' halo *positions* (append-only;
  first ``n_frontier`` live).  The ``"psum"`` backend moves these
  ``(H_pad, N_trie)`` rows per depth step — one ``psum`` (``all_reduce``)
  over the group completes the union because each frontier row has
  exactly one owner (``fr_local_idx`` / ``fr_owned``).
* ``send_local`` / ``src_map_sliced`` — the ``"sliced"`` backend's
  per-shard-pair slice tables: ``send_local[o, j]`` lists the local rows
  shard ``o`` must ship to shard ``j`` (only what ``j`` actually reads).
  The ragged all-to-all is decomposed into ``S - 1`` ring rounds (round
  ``r``: every shard ships its slice to the shard ``r`` hops ahead, one
  send and one receive a rank), each padded only to *that round's* largest pair
  (``round_cap[r]``) — so per-depth bytes are ``sum(round_cap)`` rows per
  shard, scaling with what each shard actually *reads* instead of the
  global union, and one heavy pair inflates one round, not every pair.
  Slot assignment (``fr_slot``) is append-only: a frontier row's slot in a
  pair list is fixed when the reader first gathers it, so mutations never
  shuffle previously-uploaded tables.

  The sliced backend is **two-tier**: skewed graphs have hub rows read by
  most shards, and a row read by ``r`` readers costs ``r`` pair slots (and
  inflates the max pairwise halo every pair list is padded to) but only
  one row in a broadcast union.  Build time therefore splits the frontier
  by read-degree — rows read by at least ``t`` shards form the **hot**
  union (``hot_local_idx`` / ``hot_owned``: a small psum'd buffer, one
  copy per depth) and the cold tail flows through the pair slices — with
  ``t`` chosen per packing by exact cost scan over the read-degree
  histogram (``hot_pad + sum(round_cap)`` minimised; the scan includes the
  no-hot-tier extreme, so the hybrid never loses to pure slicing).
  Mutation-appended rows always join the cold tier (their read degree is
  unknown); a scratch rebuild re-tiers.

* ``src_map`` — per-shard source indices remapped into the concatenated
  ``[local rows | exchanged rows]`` index space, so the kernel gathers
  from one contiguous ``beta`` buffer without runtime translation.  For
  psum the exchanged segment is the union frontier (offset ``n_local_pad
  + frontier index``); for sliced it is ``[hot union | round 1 slice |
  ... | round S-1 slice]`` (offset ``n_local_pad + hot_pad +
  round_base[(reader - owner) % S] + fr_slot``, each round padded to its
  own ``round_cap``).
* ``slot_raw`` — packed slot -> raw edge id, so per-slot edge masses scatter
  back into the graph's raw edge order on the host.

Like :meth:`LabelledGraph.vm_packing`, the packing is partition-independent
*given a shard map* and version-keyed.  After
:meth:`LabelledGraph.apply_mutations` the cached packing is **patched per
dirty shard** (:func:`patch_sharded_vm_packing`): only shards whose
destination blocks contain a mutated endpoint are refilled, new halo
positions are *appended* to the frontier and to the pair lists (existing
slots stay valid, so unaffected shards' maps survive untouched; owners whose
send tables grew bump their epoch), brand-new vertices extend the shard map
with an identity tail, and per-shard ``shard_epoch`` counters tell
device-buffer caches exactly which shard slices to re-upload.  Capacity
headroom (``EB_SLACK`` spare edge blocks per shard, ``FR_SLACK`` spare
frontier rows, ``PAIR_SLACK`` spare pair-list slots) absorbs modest growth
without a shape change; overflowing it evicts the entry for a scratch
rebuild.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

#: spare edge blocks per shard so mutations can grow a shard in place
EB_SLACK = 2
#: spare frontier rows so mutations can append halo vertices in place
FR_SLACK = 64
#: spare per-shard-pair slice slots so mutations can append reads in place
PAIR_SLACK = 16


# ---------------------------------------------------------------------------
# shard maps (vertex -> position permutations)
# ---------------------------------------------------------------------------


def _normalize_order(order: Optional[np.ndarray], n: int,
                     validate: bool = True) -> Tuple[np.ndarray, np.ndarray, bool]:
    """``(pos_of, vtx_at, is_identity)`` for a caller-supplied shard map.

    ``order=None`` is the identity (stripe).  A map shorter than ``n`` is
    extended with an identity tail — vertices born after the map was drawn
    keep position == id, exactly how :func:`patch_sharded_vm_packing` grows
    a live packing."""
    if order is None:
        ar = np.arange(n, dtype=np.int64)
        return ar, ar, True
    pos_of = np.asarray(order, dtype=np.int64).reshape(-1)
    if pos_of.shape[0] > n:
        raise ValueError("shard map longer than the vertex range")
    if validate and pos_of.shape[0] and (
            pos_of.min() < 0 or pos_of.max() >= pos_of.shape[0]
            or np.bincount(pos_of, minlength=pos_of.shape[0]).max() != 1):
        raise ValueError("shard map must be a permutation of its range")
    if pos_of.shape[0] < n:
        pos_of = np.concatenate(
            [pos_of, np.arange(pos_of.shape[0], n, dtype=np.int64)])
    vtx_at = np.empty(n, dtype=np.int64)
    vtx_at[pos_of] = np.arange(n, dtype=np.int64)
    identity = bool((pos_of == np.arange(n, dtype=np.int64)).all())
    return pos_of, vtx_at, identity


def partition_shard_order(part: np.ndarray, n_shards: int) -> np.ndarray:
    """Vertex positions dealt along a partition vector (``pos_of``).

    Partitions are folded into ``n_shards`` groups by greedy
    largest-partition-first bin packing (exact when k == n_shards: one
    partition per shard, sizes permitting), then vertices are laid out
    group-major, partition-minor, id-minor — so each shard's contiguous
    position range covers whole partitions wherever the fold allows."""
    part = np.asarray(part, dtype=np.int64).reshape(-1)
    if part.size == 0:
        return np.empty(0, dtype=np.int64)
    k = int(part.max()) + 1
    sizes = np.bincount(np.maximum(part, 0), minlength=k)
    group = np.zeros(k, dtype=np.int64)
    load = np.zeros(max(int(n_shards), 1), dtype=np.int64)
    for p in np.argsort(-sizes):
        g_ = int(np.argmin(load))
        group[p] = g_
        load[g_] += sizes[p]
    key = group[np.maximum(part, 0)] * (k + 1) + np.maximum(part, 0)
    vtx_at = np.argsort(key, kind="stable")
    pos_of = np.empty(part.size, dtype=np.int64)
    pos_of[vtx_at] = np.arange(part.size, dtype=np.int64)
    return pos_of


def bfs_shard_order(g) -> np.ndarray:
    """BFS visitation order from high-degree seeds (``pos_of``).

    A cheap community/locality ordering for graphs with no partition yet:
    neighbours are discovered together, so contiguous position ranges land
    on densely-connected vertex groups."""
    n = g.n
    pos_of = np.full(n, -1, dtype=np.int64)
    visited = np.zeros(n, dtype=bool)
    seeds = np.argsort(-g.degrees, kind="stable")
    seed_i = 0
    nxt = 0
    while nxt < n:
        while seed_i < n and visited[seeds[seed_i]]:
            seed_i += 1
        if seed_i >= n:
            break
        frontier = np.asarray([seeds[seed_i]], dtype=np.int64)
        visited[frontier] = True
        while frontier.size:
            pos_of[frontier] = np.arange(nxt, nxt + frontier.size)
            nxt += int(frontier.size)
            nbrs = g.dst[g.edge_indices_of(frontier)].astype(np.int64)
            nbrs = np.unique(nbrs[~visited[nbrs]])
            visited[nbrs] = True
            frontier = nbrs
    rest = np.nonzero(pos_of < 0)[0]
    pos_of[rest] = np.arange(nxt, nxt + rest.size)
    return pos_of


def compute_shard_order(g, source: str, n_shards: int,
                        part: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
    """Resolve a ``shard_map_source`` name into a ``pos_of`` permutation."""
    if source == "stripe":
        return None
    if source == "partition":
        if part is None:
            raise ValueError('shard_map_source="partition" needs a partition')
        return partition_shard_order(part, n_shards)
    if source == "bfs":
        return bfs_shard_order(g)
    raise ValueError(f"unknown shard_map_source {source!r}")


# ---------------------------------------------------------------------------
# the packing
# ---------------------------------------------------------------------------


@dataclass
class ShardedVMPacking:
    """Stacked per-shard ``vm_step`` inputs (leading axis = shard)."""

    n_shards: int
    block_n: int
    block_e: int
    blocks_per_shard: int          # destination blocks per shard (capacity)
    n_local_pad: int               # blocks_per_shard * block_n
    eb_cap: int                    # edge blocks per shard (incl. slack)
    meta: np.ndarray               # (S, eb_cap, 2) [local dst block, is_first]
    src_map: np.ndarray            # (S, e_pad) int32 into [local | frontier]
    src_global: np.ndarray         # (S, e_pad) int32 global source vertex id
    dst_local: np.ndarray          # (S, e_pad) int32 within-block dst position
    dst_global: np.ndarray         # (S, e_pad) int32 global destination id
    dst_label: np.ndarray          # (S, e_pad) int32 label of destination
    inv_cnt: np.ndarray            # (S, e_pad) f32 1/cnt[src, l(dst)], 0 pad
    slot_raw: np.ndarray           # (S, e_pad) int64 raw edge id, -1 pad
    vlabels: np.ndarray            # (S, n_local_pad) int32 owned labels, -1 pad
    frontier: np.ndarray           # (H_pad,) int64 positions; n_frontier live
    n_frontier: int
    fr_local_idx: np.ndarray       # (S, H_pad) int32 owner-local row
    fr_owned: np.ndarray           # (S, H_pad) f32 1.0 iff shard owns entry
    version: int                   # graph version the arrays reflect
    # -- shard map (vertex id <-> position permutation) --------------------
    pos_of: np.ndarray = field(default=None)   # (n,) int64 vertex -> position
    vtx_at: np.ndarray = field(default=None)   # (n,) int64 position -> vertex
    order_token: str = "stripe"    # identity of the shard map (cache key)
    identity: bool = True          # fast path: position == vertex id
    # -- sliced (two-tier: hot union + per-shard-pair) exchange tables -----
    pair_cap: int = 8              # send_local slot width: max(round_cap)
    round_cap: np.ndarray = field(default=None)  # (S,) padded slots per ring
                                                 # round; [0] unused (self)
    fr_reads: np.ndarray = field(default=None)   # (S, H_pad) bool reader map
    fr_slot: np.ndarray = field(default=None)    # (S, H_pad) int32 pair slot
    pair_cnt: np.ndarray = field(default=None)   # (S, S) int32 live slots
    send_local: np.ndarray = field(default=None)  # (S, S, pair_cap) int32
    src_map_sliced: np.ndarray = field(default=None)  # (S, e_pad) int32
    n_hot: int = 0                 # hot-tier rows (read-degree >= threshold)
    fr_hot_pos: np.ndarray = field(default=None)  # (H_pad,) int32, -1 = cold
    hot_local_idx: np.ndarray = field(default=None)  # (S, hot_pad) int32
    hot_owned: np.ndarray = field(default=None)      # (S, hot_pad) f32
    shard_epoch: np.ndarray = field(default=None)  # (S,) int64 change counters
    fr_epoch: int = 0

    def __post_init__(self):
        if self.shard_epoch is None:
            self.shard_epoch = np.zeros(self.n_shards, dtype=np.int64)

    @property
    def e_pad(self) -> int:
        return self.eb_cap * self.block_e

    @property
    def h_pad(self) -> int:
        return int(self.frontier.shape[0])

    @property
    def hot_pad(self) -> int:
        return int(self.hot_local_idx.shape[1])

    @property
    def round_base(self) -> np.ndarray:
        """(S,) receive-buffer row offset of ring round ``r``'s slice
        (``round_base[r] = sum(round_cap[1:r])``; entry 0 unused)."""
        base = np.zeros(self.n_shards, dtype=np.int64)
        if self.n_shards > 1:
            base[1:] = np.concatenate(
                [[0], np.cumsum(self.round_cap[1:-1])])
        return base

    def halo_bytes_per_depth(self, n_trie: int, itemsize: int = 4,
                             exchange: str = "psum") -> int:
        """Bytes each shard receives per depth step under ``exchange``:
        the psum'd union frontier, or the sliced hot union plus the
        per-round-padded ring slices."""
        if exchange == "sliced":
            rows = self.hot_pad + int(self.round_cap[1:].sum())
            return rows * n_trie * itemsize
        return self.h_pad * n_trie * itemsize

    def full_field_bytes_per_depth(self, n: int, n_trie: int,
                                   itemsize: int = 4) -> int:
        """Bytes an all-gather of the full field would move instead."""
        return n * n_trie * itemsize

    def scatter_slot_values(self, values: np.ndarray, m: int,
                            dtype=np.float32) -> np.ndarray:
        """Scatter per-slot values (flattened ``(S * e_pad,)`` or
        ``(S, e_pad)``) back into raw edge order."""
        flat = np.asarray(values).reshape(-1)
        raw = self.slot_raw.reshape(-1)
        ok = raw >= 0
        out = np.zeros(m, dtype=dtype)
        out[raw[ok]] = flat[ok]
        return out


def _dst_sorted_view(
        g, sp: Optional[ShardedVMPacking] = None,
        pos_of: Optional[np.ndarray] = None, identity: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """``(e_src, e_dst, e_dpos, e_raw)`` — the edge list sorted by
    destination *position*, with ``e_dpos`` the destination positions and
    ``e_raw`` the raw (``(src, dst)``-sorted) index of each edge.

    Under the identity shard map, symmetric graphs get this for free: the
    dst-sorted view is the raw arrays with roles swapped, and the sort
    permutation is the reverse-edge involution (the identity ``vm_packing``
    patching already exploits)."""
    if sp is not None:
        pos_of, identity = sp.pos_of, sp.identity
    if identity:
        if g.is_symmetric():
            return g.dst, g.src, g.src, g.reverse_edge_index
        order = np.lexsort((g.src, g.dst))
        d = g.dst[order]
        return g.src[order], d, d, order
    dpos = pos_of[g.dst]
    order = np.lexsort((g.src, dpos))
    return g.src[order], g.dst[order], dpos[order], order


def _fill_shard(sp: ShardedVMPacking, s: int, g, cnt,
                e_src: np.ndarray, e_dst: np.ndarray, e_dpos: np.ndarray,
                e_raw: np.ndarray) -> Optional[np.ndarray]:
    """Refill shard ``s``'s packed rows from the current graph.

    Returns the shard's halo *position* array (sorted unique), or ``None``
    when the shard's real edges no longer fit ``eb_cap`` (caller must
    rebuild).  Does not touch the source maps — the caller remaps after
    frontier updates."""
    bn, be, bps = sp.block_n, sp.block_e, sp.blocks_per_shard
    blocks = np.arange(s * bps, (s + 1) * bps, dtype=np.int64)
    vlo_all = np.minimum(blocks * bn, g.n)
    vhi_all = np.minimum((blocks + 1) * bn, g.n)
    lo_all = np.searchsorted(e_dpos, vlo_all)
    hi_all = np.searchsorted(e_dpos, vhi_all)
    cnt_b = hi_all - lo_all
    eb_need = np.maximum(1, -(-cnt_b // be))
    if int(eb_need.sum()) > sp.eb_cap:
        return None

    sp.meta[s] = 0                      # pad rows: block 0, is_first=0
    sp.src_global[s] = 0
    sp.dst_local[s] = 0
    sp.dst_global[s] = 0
    sp.dst_label[s] = 0
    sp.inv_cnt[s] = 0.0
    sp.slot_raw[s] = -1

    eb_off = np.concatenate([[0], np.cumsum(eb_need)])
    labels = g.labels
    for i, b in enumerate(blocks.tolist()):
        lo, hi = int(lo_all[i]), int(hi_all[i])
        c = hi - lo
        o = int(eb_off[i]) * be
        if c:
            es = e_src[lo:hi]
            ed = e_dst[lo:hi]
            sp.src_global[s, o:o + c] = es
            sp.dst_local[s, o:o + c] = e_dpos[lo:hi] - b * bn
            sp.dst_global[s, o:o + c] = ed
            dl = labels[ed]
            sp.dst_label[s, o:o + c] = dl
            sp.inv_cnt[s, o:o + c] = 1.0 / np.maximum(
                cnt[es, dl].astype(np.float32), 1.0)
            sp.slot_raw[s, o:o + c] = e_raw[lo:hi]
        blk_meta = sp.meta[s, eb_off[i]:eb_off[i + 1]]
        blk_meta[:, 0] = i              # local destination block id
        blk_meta[0, 1] = 1              # first edge block zero-inits output

    # owned labels (pad rows beyond n get -1, which never matches a prior)
    plo, phi = s * sp.n_local_pad, min((s + 1) * sp.n_local_pad, g.n)
    sp.vlabels[s] = -1
    if phi > plo:
        sp.vlabels[s, : phi - plo] = labels[sp.vtx_at[plo:phi]]

    real = sp.slot_raw[s] >= 0
    srcs = np.unique(sp.src_global[s][real])
    spos = sp.pos_of[srcs]
    lo_own, hi_own = s * sp.n_local_pad, (s + 1) * sp.n_local_pad
    halo = spos[(spos < lo_own) | (spos >= hi_own)]
    halo.sort()
    return halo


def _mark_reads(sp: ShardedVMPacking, s: int, fidx: np.ndarray):
    """Record that shard ``s`` reads the frontier rows at ``fidx``.

    New *cold* reads are assigned append-only slots in their owner's pair
    list (``fr_slot``) and written into ``send_local``; hot-tier rows are
    broadcast to every shard anyway, so a fresh reader costs nothing.
    Returns the array of owner shards whose send tables changed (callers
    bump their epochs), or ``None`` when a pair list would overflow its
    ring round's capacity (caller evicts and rebuilds).  Reads are
    monotone: a refilled shard that stops reading a row keeps its
    (harmless, stale) slot — exactly like stale frontier entries — which
    is what keeps every previously-issued slot valid."""
    fidx = np.asarray(fidx, dtype=np.int64)
    fidx = fidx[~sp.fr_reads[s, fidx]]
    if fidx.size == 0:
        return np.empty(0, dtype=np.int64)
    hot = sp.fr_hot_pos[fidx] >= 0
    sp.fr_reads[s, fidx[hot]] = True
    fidx = fidx[~hot]
    if fidx.size == 0:
        return np.empty(0, dtype=np.int64)
    owners = sp.frontier[fidx] // sp.n_local_pad
    order = np.argsort(owners, kind="stable")
    fidx, owners = fidx[order], owners[order]
    uo, starts, counts = np.unique(
        owners, return_index=True, return_counts=True)
    cap = sp.round_cap[(s - uo) % sp.n_shards]
    if (sp.pair_cnt[uo, s] + counts > cap).any():
        return None
    ranks = np.arange(fidx.size, dtype=np.int64) - np.repeat(starts, counts)
    slots = sp.pair_cnt[owners, s].astype(np.int64) + ranks
    sp.fr_slot[s, fidx] = slots.astype(np.int32)
    sp.fr_reads[s, fidx] = True
    sp.send_local[owners, s, slots] = (
        sp.frontier[fidx] - owners * sp.n_local_pad).astype(np.int32)
    sp.pair_cnt[uo, s] += counts.astype(np.int32)
    return uo


def _remap_shard_src(sp: ShardedVMPacking, s: int) -> None:
    """Rewrite shard ``s``'s source maps against the current frontier.

    ``src_map`` indexes ``[local | union frontier]`` (psum exchange);
    ``src_map_sliced`` indexes ``[local | hot union | (owner, pair slot)
    receive buffer]`` (two-tier all_to_all exchange).  Every halo source
    must already be marked in ``fr_reads[s]`` (:func:`_mark_reads`)."""
    fr = sp.frontier[: sp.n_frontier]
    order = np.argsort(fr, kind="stable")
    fr_sorted = fr[order]
    sg = sp.src_global[s].astype(np.int64)
    spos = sp.pos_of[sg]
    owned = (spos >= s * sp.n_local_pad) & (spos < (s + 1) * sp.n_local_pad)
    real = sp.slot_raw[s] >= 0
    pos = np.searchsorted(fr_sorted, spos)
    pos = np.minimum(pos, max(sp.n_frontier - 1, 0))
    fr_idx = order[pos] if sp.n_frontier else np.zeros_like(pos)
    local = spos - s * sp.n_local_pad
    remapped = np.where(owned, local, sp.n_local_pad + fr_idx)
    sp.src_map[s] = np.where(real, remapped, 0).astype(np.int32)
    fr_owner = sp.frontier[fr_idx] // sp.n_local_pad
    hot_pos = sp.fr_hot_pos[fr_idx]
    rnd = (s - fr_owner) % sp.n_shards
    cold = (sp.n_local_pad + sp.hot_pad
            + sp.round_base[rnd] + sp.fr_slot[s, fr_idx])
    exchanged = np.where(hot_pos >= 0, sp.n_local_pad + hot_pos, cold)
    remapped_sl = np.where(owned, local, exchanged)
    sp.src_map_sliced[s] = np.where(real, remapped_sl, 0).astype(np.int32)


def build_sharded_vm_packing(g, n_shards: int, cnt: np.ndarray,
                             block_n: int = 128,
                             block_e: int = 256,
                             order: Optional[np.ndarray] = None,
                             order_token: str = "stripe") -> ShardedVMPacking:
    """Build the stacked per-shard packing from scratch (see module doc).

    ``order`` is the shard map (``pos_of``: vertex id -> position), ``None``
    for the identity stripe; ``order_token`` names it for cache keying."""
    S = int(n_shards)
    if S < 1:
        raise ValueError("n_shards must be >= 1")
    pos_of, vtx_at, identity = _normalize_order(order, g.n)
    nb = max(1, -(-g.n // block_n))
    bps = -(-nb // S)
    n_local_pad = bps * block_n

    e_src, e_dst, e_dpos, e_raw = _dst_sorted_view(
        g, pos_of=pos_of, identity=identity)

    # capacity pass: per-shard edge-block need (every block gets >= 1)
    blocks = np.arange(S * bps, dtype=np.int64)
    lo = np.searchsorted(e_dpos, np.minimum(blocks * block_n, g.n))
    hi = np.searchsorted(e_dpos, np.minimum((blocks + 1) * block_n, g.n))
    eb_need = np.maximum(1, -(-(hi - lo) // block_e)).reshape(S, bps)
    eb_cap = int(eb_need.sum(axis=1).max()) + EB_SLACK
    e_pad = eb_cap * block_e

    sp = ShardedVMPacking(
        n_shards=S, block_n=block_n, block_e=block_e,
        blocks_per_shard=bps, n_local_pad=n_local_pad, eb_cap=eb_cap,
        meta=np.zeros((S, eb_cap, 2), np.int32),
        src_map=np.zeros((S, e_pad), np.int32),
        src_global=np.zeros((S, e_pad), np.int32),
        dst_local=np.zeros((S, e_pad), np.int32),
        dst_global=np.zeros((S, e_pad), np.int32),
        dst_label=np.zeros((S, e_pad), np.int32),
        inv_cnt=np.zeros((S, e_pad), np.float32),
        slot_raw=np.full((S, e_pad), -1, np.int64),
        vlabels=np.full((S, n_local_pad), -1, np.int32),
        frontier=np.empty(0, np.int64),   # placeholder until halos known
        n_frontier=0,
        fr_local_idx=np.empty((S, 0), np.int32),
        fr_owned=np.empty((S, 0), np.float32),
        version=g.version,
        pos_of=pos_of, vtx_at=vtx_at,
        order_token=order_token, identity=identity,
    )

    halos = []
    for s in range(S):
        halo = _fill_shard(sp, s, g, cnt, e_src, e_dst, e_dpos, e_raw)
        assert halo is not None  # capacity was sized for exactly this graph
        halos.append(halo)
    frontier = (np.unique(np.concatenate(halos)) if halos
                else np.empty(0, np.int64))
    H = int(frontier.size)
    h_pad = -(-(H + FR_SLACK) // 8) * 8
    sp.frontier = np.zeros(h_pad, np.int64)
    sp.frontier[:H] = frontier
    sp.n_frontier = H
    sp.fr_local_idx = np.zeros((S, h_pad), np.int32)
    sp.fr_owned = np.zeros((S, h_pad), np.float32)
    _refresh_frontier_rows(sp, np.arange(H))

    # sliced exchange tables: split the frontier into a hot broadcast tier
    # and cold pair slices at the cost-optimal read-degree threshold, size
    # pair_cap from the cold pairwise maxima, then assign slots through the
    # same append-only path mutations use
    owners_all = frontier // n_local_pad if H else np.empty(0, np.int64)
    fidx_of = {s: np.searchsorted(frontier, halos[s]) for s in range(S)}
    _build_tiers(sp, fidx_of, owners_all, H)
    sp.fr_reads = np.zeros((S, h_pad), dtype=bool)
    sp.fr_slot = np.zeros((S, h_pad), np.int32)
    sp.pair_cnt = np.zeros((S, S), np.int32)
    sp.send_local = np.zeros((S, S, sp.pair_cap), np.int32)
    sp.src_map_sliced = np.zeros((S, e_pad), np.int32)
    for s in range(S):
        changed = _mark_reads(sp, s, fidx_of[s])
        assert changed is not None      # pair_cap was sized for these reads
    for s in range(S):
        _remap_shard_src(sp, s)
    return sp


def _build_tiers(sp: ShardedVMPacking, fidx_of, owners_all: np.ndarray,
                 H: int) -> None:
    """Split the frontier into hot/cold exchange tiers (module doc).

    A frontier row read by ``r`` shards costs ``r`` cold pair slots (and
    pushes its ring round's padding) but exactly one hot-union row, so the
    per-depth receive footprint ``hot_pad + sum(round_cap)`` is minimised
    by an exact scan over read-degree thresholds ``t``: rows with
    ``r >= t`` go hot.  ``t = S + 1`` (everything cold) is in the scan, so
    the two-tier layout never costs more than pure pair slicing."""
    S = sp.n_shards

    def _pad8(x, slack=0):
        return max(8, -(-(int(x) + slack) // 8) * 8)

    if H == 0 or S == 1:
        sp.n_hot = 0
        sp.fr_hot_pos = np.full(sp.h_pad, -1, np.int32)
        sp.hot_local_idx = np.zeros((S, 8), np.int32)
        sp.hot_owned = np.zeros((S, 8), np.float32)
        sp.round_cap = np.full(S, 8, np.int64)
        sp.round_cap[0] = 0
        sp.pair_cap = 8
        return
    r_deg = np.zeros(H, dtype=np.int64)
    for s in range(S):
        r_deg[fidx_of[s]] += 1
    # hist[(owner, reader), r]: cold pair-list sizes per candidate threshold
    hist = np.zeros((S * S, S + 1), dtype=np.int64)
    for s in range(S):
        fidx = fidx_of[s]
        if fidx.size:
            np.add.at(hist, (owners_all[fidx] * S + s, r_deg[fidx]), 1)
    cold_prefix = np.cumsum(hist, axis=1)      # reads with r <= t per pair
    hh_suffix = np.cumsum(np.bincount(r_deg, minlength=S + 2)[::-1])[::-1]
    # ring round of pair (owner o, reader j): j receives from o at round
    # (j - o) mod S; each round is padded to its own largest pair
    pair_round = (np.arange(S * S) % S
                  - np.arange(S * S) // S) % S   # (o * S + j) -> round

    def _round_caps(col: np.ndarray) -> np.ndarray:
        caps = np.zeros(S, dtype=np.int64)
        np.maximum.at(caps, pair_round, col)
        return caps

    best_t, best_cost, best_caps = None, None, None
    for t in range(2, S + 2):
        hh = int(hh_suffix[t])                       # rows with r >= t
        caps = _round_caps(cold_prefix[:, t - 1])    # per-round cold maxima
        cost = _pad8(hh) + sum(
            _pad8(c, PAIR_SLACK) for c in caps[1:])
        if best_cost is None or cost < best_cost:
            best_t, best_cost, best_caps = t, cost, caps
    hot_rows = np.nonzero(r_deg >= best_t)[0]
    sp.n_hot = int(hot_rows.size)
    hot_pad = _pad8(sp.n_hot)
    sp.fr_hot_pos = np.full(sp.h_pad, -1, np.int32)
    sp.fr_hot_pos[hot_rows] = np.arange(sp.n_hot, dtype=np.int32)
    sp.hot_local_idx = np.zeros((S, hot_pad), np.int32)
    sp.hot_owned = np.zeros((S, hot_pad), np.float32)
    if sp.n_hot:
        vs = sp.frontier[hot_rows]
        owners = vs // sp.n_local_pad
        cols = np.arange(sp.n_hot)
        sp.hot_local_idx[owners, cols] = (
            vs - owners * sp.n_local_pad).astype(np.int32)
        sp.hot_owned[owners, cols] = 1.0
    sp.round_cap = np.asarray(
        [0] + [_pad8(c, PAIR_SLACK) for c in best_caps[1:]], np.int64)
    sp.pair_cap = int(sp.round_cap.max()) if S > 1 else 8


def _refresh_frontier_rows(sp: ShardedVMPacking, positions: np.ndarray) -> None:
    """(Re)write the owner maps for the given frontier positions."""
    if positions.size == 0:
        return
    vs = sp.frontier[positions]
    owners = (vs // sp.n_local_pad).astype(np.int64)
    owners = np.minimum(owners, sp.n_shards - 1)
    sp.fr_local_idx[:, positions] = 0
    sp.fr_owned[:, positions] = 0.0
    sp.fr_local_idx[owners, positions] = (
        vs - owners * sp.n_local_pad).astype(np.int32)
    sp.fr_owned[owners, positions] = 1.0


def patch_sharded_vm_packing(sp: ShardedVMPacking, g, cnt: np.ndarray,
                             changed_dsts: np.ndarray,
                             changed_pairs: np.ndarray,
                             n_old: int, old2new: np.ndarray) -> bool:
    """Patch ``sp`` in place across one applied mutation.

    ``changed_dsts`` are the destination endpoints of every added/removed
    directed edge; ``changed_pairs`` the ``src * L + label(dst)`` keys whose
    neighbour-label count changed; ``old2new`` the mutation's edge position
    map (all as computed by ``apply_mutations``).  Only shards whose
    destination blocks contain a changed endpoint (plus shards gaining
    vertices) are refilled; fresh halo positions are appended to the
    frontier and to the pair slice tables so every other shard's maps stay
    valid; brand-new vertices extend the shard map with an identity tail
    (position == id).  Returns ``False`` when capacity is exceeded (caller
    evicts and rebuilds)."""
    if not g.is_symmetric():
        return False
    bn, bps, S = sp.block_n, sp.blocks_per_shard, sp.n_shards
    nb_new = max(1, -(-g.n // bn))
    if nb_new > S * bps:
        return False                       # vertex growth exceeded capacity
    nb_old = max(1, -(-n_old // bn))
    if g.n > sp.pos_of.shape[0]:
        # new vertices take identity-tail positions (old2new composes with
        # the permutation because existing positions never move)
        tail = np.arange(sp.pos_of.shape[0], g.n, dtype=np.int64)
        sp.pos_of = np.concatenate([sp.pos_of, tail])
        sp.vtx_at = np.concatenate([sp.vtx_at, tail])

    # every shard's slot -> raw-edge map must follow the global edge
    # renumbering (host-side only — device buffers never hold slot_raw,
    # so this re-indexing does not dirty any shard's upload epoch)
    ok = sp.slot_raw >= 0
    sp.slot_raw[ok] = old2new[sp.slot_raw[ok]]
    aff_blocks = np.unique(np.concatenate([
        sp.pos_of[np.asarray(changed_dsts, dtype=np.int64)] // bn,
        np.arange(nb_old, nb_new, dtype=np.int64),
    ]))
    # vertex growth changes vlabels rows even without edges
    grow_shards = (np.arange(n_old // sp.n_local_pad,
                             -(-g.n // sp.n_local_pad), dtype=np.int64)
                   if g.n > n_old else np.empty(0, np.int64))
    aff_shards = np.unique(np.concatenate([
        aff_blocks // bps, grow_shards]))
    aff_shards = aff_shards[(aff_shards >= 0) & (aff_shards < S)]

    e_src, e_dst, e_dpos, e_raw = _dst_sorted_view(g, sp=sp)
    live = set(sp.frontier[: sp.n_frontier].tolist())
    appends = set()
    halos = {}
    for s in aff_shards.tolist():
        halo = _fill_shard(sp, s, g, cnt, e_src, e_dst, e_dpos, e_raw)
        if halo is None:
            return False                   # edge growth exceeded capacity
        halos[s] = halo
        for v in halo.tolist():
            if v not in live:
                appends.add(v)
    if appends:
        new = np.fromiter(sorted(appends), dtype=np.int64)
        if sp.n_frontier + new.size > sp.h_pad:
            return False                   # frontier slack exhausted
        pos = np.arange(sp.n_frontier, sp.n_frontier + new.size)
        sp.frontier[pos] = new
        sp.n_frontier += int(new.size)
        _refresh_frontier_rows(sp, pos)
        sp.fr_epoch += 1

    # sliced tables: append-only slot assignment for fresh reads; owners
    # whose send tables grew must re-upload their shard slice
    fr_order = np.argsort(sp.frontier[: sp.n_frontier], kind="stable")
    fr_sorted = sp.frontier[: sp.n_frontier][fr_order]
    dirty_owners = set()
    for s, halo in halos.items():
        fidx = fr_order[np.searchsorted(fr_sorted, halo)]
        changed = _mark_reads(sp, s, fidx)
        if changed is None:
            return False                   # pair-slot slack exhausted
        dirty_owners.update(changed.tolist())

    for s in aff_shards.tolist():
        _remap_shard_src(sp, s)
        sp.shard_epoch[s] += 1
    for o in sorted(dirty_owners - set(aff_shards.tolist())):
        sp.shard_epoch[o] += 1

    # refresh 1/cnt on slots of *unaffected* shards whose (src, dst-label)
    # count changed (their packed structure is untouched)
    changed_pairs = np.asarray(changed_pairs, dtype=np.int64)
    if changed_pairs.size:
        L = g.n_labels
        untouched = np.setdiff1d(np.arange(S, dtype=np.int64), aff_shards)
        for s in untouched.tolist():
            real = sp.slot_raw[s] >= 0
            keys = sp.src_global[s].astype(np.int64) * L + sp.dst_label[s]
            upd = real & np.isin(keys, changed_pairs)
            if upd.any():
                sp.inv_cnt[s][upd] = 1.0 / np.maximum(
                    cnt[sp.src_global[s][upd],
                        sp.dst_label[s][upd]].astype(np.float32), 1.0)
                sp.shard_epoch[s] += 1

    sp.version = g.version
    return True
