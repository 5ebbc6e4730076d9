"""The port's sharded packing against the JAX reference's.

The same seeded graphs, shard maps and ``MutationBatch``es go into
``repro.graphs.sharded_packing`` and ``repro_torch.graphs.sharded_packing``:
every array of ``ShardedVMPacking`` (maps, exchange tables, ``round_cap``,
hot tier, epochs), its byte counts and its slot scatter are bitwise the
reference's — built from scratch, patched in place across mutation batches
(and then also equal to a scratch repack), and rebuilt after a capacity
overflow.  A shard's CSR (``csr_from_shard``) keeps the global CSR's
per-destination order; ``apply_mutations`` handles every kind of cached
entry."""
import dataclasses

import numpy as np
import pytest

from repro.graphs import generators as rgen
from repro.graphs import sharded_packing as rsp
from repro.graphs.graph import MutationBatch as RMutationBatch
from repro.graphs.partition import hash_partition, metis_like_partition

from repro_torch.convert import from_reference_arrays
from repro_torch.graphs import sharded_packing as psp
from repro_torch.graphs.graph import LabelledGraph, MutationBatch
from repro_torch.kernels.segment_spmm.ops import csr_from_shard

MAPS = ("stripe", "partition", "bfs")


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _pair(gen, n, seed, **kw):
    rg = getattr(rgen, gen)(n, seed=seed, **kw)
    g = from_reference_arrays(graph=dict(
        n=rg.n, labels=rg.labels, label_names=rg.label_names, src=rg.src,
        dst=rg.dst)).graph
    return g, rg


def _same_packing(sp, rsp_):
    """Every field, property and byte count of two packings, bitwise."""
    for f in dataclasses.fields(rsp.ShardedVMPacking):
        a, b = getattr(sp, f.name), getattr(rsp_, f.name)
        if isinstance(b, np.ndarray):
            assert _eq(a, b), f.name
        else:
            assert type(a) is type(b) and a == b, f.name
    assert _eq(sp.round_base, rsp_.round_base)
    assert (sp.e_pad, sp.h_pad, sp.hot_pad) == (rsp_.e_pad, rsp_.h_pad, rsp_.hot_pad)
    for n_trie in (5, 23):
        for ex in ("psum", "sliced"):
            assert (sp.halo_bytes_per_depth(n_trie, exchange=ex)
                    == rsp_.halo_bytes_per_depth(n_trie, exchange=ex))
    assert sp.full_field_bytes_per_depth(777, 9) == rsp_.full_field_bytes_per_depth(777, 9)
    for n_trie, n in ((5, 900), (23, 1234)):
        assert sp.exchange_metrics(n_trie, n) == rsp_.exchange_metrics(n_trie, n)
    verts = np.arange(sp.pos_of.shape[0])
    assert _eq(sp.owner_of(verts), rsp_.owner_of(verts))
    assert sp.owner_of(int(verts[-1])) == rsp_.owner_of(int(verts[-1]))
    vals = np.random.default_rng(0).random(sp.slot_raw.shape).astype(np.float32)
    m = int((sp.slot_raw >= 0).sum())
    assert _eq(sp.scatter_slot_values(vals, m), rsp_.scatter_slot_values(vals, m))


def _order(source, rg, n_shards, seed=0):
    """The reference's shard map for ``source`` (fed to both sides)."""
    part = metis_like_partition(rg, 4, seed=seed) if source == "partition" else None
    return rsp.compute_shard_order(rg, source, n_shards, part=part)


@pytest.mark.parametrize("blocks", [(128, 256), (64, 128)])
@pytest.mark.parametrize("source", MAPS)
@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_packing_equals_reference(n_shards, source, blocks):
    g, rg = _pair("musicbrainz_like", 900, 41)
    bn, be = blocks
    order = _order(source, rg, n_shards)
    if order is not None:
        assert _eq(psp.compute_shard_order(
            g, source, n_shards,
            part=metis_like_partition(rg, 4, seed=0) if source == "partition" else None),
            order)
    token = f"{source}:0"
    sp = g.vm_packing_sharded(n_shards, block_n=bn, block_e=be, order=order,
                              order_token=token)
    ref = rg.vm_packing_sharded(n_shards, block_n=bn, block_e=be, order=order,
                                order_token=token)
    _same_packing(sp, ref)
    assert g.vm_packing_sharded(n_shards, block_n=bn, block_e=be, order=order,
                                order_token=token) is sp


@pytest.mark.parametrize("seed", range(3))
def test_packing_on_power_law_graphs_equals_reference(seed):
    g, rg = _pair("power_law_labelled", 300 + 100 * seed, seed, n_labels=5,
                  avg_degree=5.0)
    for n_shards in (1, 3, 8):
        order = np.random.default_rng(seed).permutation(g.n).astype(np.int64)
        _same_packing(psp.build_sharded_vm_packing(
            g, n_shards, g.neighbor_label_counts(), block_n=32, block_e=64,
            order=order, order_token="random:0"),
            rsp.build_sharded_vm_packing(
            rg, n_shards, rg.neighbor_label_counts(), block_n=32, block_e=64,
            order=order, order_token="random:0"))


def _random_batch(g, rng, nv, na, nr, rem_v=(), nrl=0):
    und = np.stack([g.src, g.dst], 1)
    und = und[und[:, 0] < und[:, 1]]
    nr = min(nr, len(und))
    hi = g.n + nv
    return dict(
        add_vertex_labels=rng.integers(0, g.n_labels, nv),
        add_edges=(np.stack([rng.integers(0, hi, na), rng.integers(0, hi, na)], 1)
                   if na else np.zeros((0, 2), np.int64)),
        remove_edges=(und[rng.choice(len(und), nr, replace=False)]
                      if nr else np.zeros((0, 2), np.int64)),
        remove_vertices=list(rem_v),
        relabel=(np.stack([rng.integers(0, hi, nrl),
                           rng.integers(0, g.n_labels, nrl)], 1)
                 if nrl else np.zeros((0, 2), np.int64)))


def _canon(p):
    raw = p.slot_raw.reshape(-1)
    ok = raw >= 0
    o = np.argsort(raw[ok])
    return [raw[ok][o]] + [getattr(p, nm).reshape(-1)[ok][o]
                           for nm in ("src_global", "dst_global", "dst_label",
                                      "inv_cnt")]


@pytest.mark.parametrize("source", MAPS)
@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_patched_packing_equals_reference_and_scratch(n_shards, source):
    g, rg = _pair("musicbrainz_like", 1500, 23)
    order = _order(source, rg, n_shards)
    token = f"{source}:0"
    kw = dict(block_n=64, block_e=128, order=order, order_token=token)
    sp = g.vm_packing_sharded(n_shards, **kw)
    ref = rg.vm_packing_sharded(n_shards, **kw)
    # a patch needs the reverse index (without it both sides rebuild)
    g.reverse_edge_index, rg.reverse_edge_index
    rng = np.random.default_rng(n_shards)
    patched = 0
    for step in range(4):
        batch = _random_batch(g, rng, nv=1, na=4, nr=3,
                              rem_v=[int(rng.integers(0, g.n))] if step == 2 else (),
                              nrl=1)
        g.apply_mutations(MutationBatch(**batch))
        rg.apply_mutations(RMutationBatch(**batch))
        # patched in place (or, past the capacity slack, rebuilt) on both
        # sides alike, to the same arrays and epochs
        sp_new = g.vm_packing_sharded(n_shards, **kw)
        ref_new = rg.vm_packing_sharded(n_shards, **kw)
        assert (sp_new is sp) == (ref_new is ref)
        patched += sp_new is sp
        sp, ref = sp_new, ref_new
        assert sp.version == g.version
        _same_packing(sp, ref)
    assert patched >= 1
    # ... and holding the same edges as a scratch repack along the same map
    scratch = psp.build_sharded_vm_packing(
        g, n_shards, g.cached_neighbor_label_counts(), block_n=64, block_e=128,
        order=sp.pos_of, order_token=token)
    for a, b in zip(_canon(sp), _canon(scratch)):
        assert _eq(a, b)
    assert _eq(sp.vlabels, scratch.vlabels)
    assert set(scratch.frontier[: scratch.n_frontier]) <= set(
        sp.frontier[: sp.n_frontier])


def test_localized_mutation_dirties_few_shards_as_reference():
    g, rg = _pair("musicbrainz_like", 4000, 22)
    sp = g.vm_packing_sharded(8, block_n=64)
    ref = rg.vm_packing_sharded(8, block_n=64)
    epochs = sp.shard_epoch.copy()
    lim = sp.n_local_pad
    batch = dict(add_edges=[(1, 5), (2, 9), (3, lim - 1)])
    g.apply_mutations(MutationBatch(**batch))
    rg.apply_mutations(RMutationBatch(**batch))
    assert g.vm_packing_sharded(8, block_n=64) is sp
    _same_packing(sp, ref)
    dirty = np.nonzero(sp.shard_epoch != epochs)[0]
    assert 1 <= dirty.size < sp.n_shards


def test_capacity_overflow_evicts_and_rebuilds_as_reference():
    g, rg = _pair("musicbrainz_like", 400, 24)
    sp = g.vm_packing_sharded(2, block_n=64)
    rg.vm_packing_sharded(2, block_n=64)
    grow = sp.n_shards * sp.n_local_pad  # guarantees nb_new > S * bps
    batch = dict(add_vertex_labels=np.zeros(grow, np.int64))
    g.apply_mutations(MutationBatch(**batch))
    rg.apply_mutations(RMutationBatch(**batch))
    assert ("sharded", 2, 64, 256) not in g._vm_pack_cache   # evicted
    sp2 = g.vm_packing_sharded(2, block_n=64)
    assert sp2 is not sp and sp2.version == g.version
    assert sp2.n_shards * sp2.n_local_pad >= g.n
    _same_packing(sp2, rg.vm_packing_sharded(2, block_n=64))


def test_partition_shard_order_k_equals_s():
    part = np.repeat(np.arange(4), 25)
    pos = psp.partition_shard_order(part, 4)
    assert _eq(pos, rsp.partition_shard_order(part, 4))
    for p in range(4):
        ps = np.sort(pos[part == p])
        assert ps[-1] - ps[0] == ps.size - 1


@pytest.mark.parametrize("k,s", [(5, 3), (12, 8), (3, 8), (2, 1)])
def test_partition_shard_order_folds_k_to_s(k, s):
    rng = np.random.default_rng(k * 31 + s)
    part = rng.integers(0, k, 400)
    pos = psp.partition_shard_order(part, s)
    assert _eq(pos, rsp.partition_shard_order(part, s))
    assert np.array_equal(np.sort(pos), np.arange(400))
    for p in range(k):
        ps = np.sort(pos[part == p])
        if ps.size:
            assert ps[-1] - ps[0] == ps.size - 1
    span = -(-400 // s)
    sizes = np.bincount(part, minlength=k)
    loads = np.bincount(np.minimum(pos // span, s - 1), minlength=s)
    assert loads.max() <= 400 / s + sizes.max()


def test_bfs_shard_order_equals_reference_and_groups_neighbours():
    g, rg = _pair("musicbrainz_like", 800, 7)
    pos = psp.bfs_shard_order(g)
    assert _eq(pos, rsp.bfs_shard_order(rg))
    rand = np.random.default_rng(0).permutation(g.n)
    d_bfs = np.abs(pos[g.src] - pos[g.dst]).mean()
    d_rand = np.abs(rand[g.src].astype(np.int64) - rand[g.dst]).mean()
    assert d_bfs < 0.6 * d_rand


def test_shard_map_must_be_a_permutation():
    g, _ = _pair("musicbrainz_like", 300, 3)
    with pytest.raises(ValueError, match="permutation"):
        psp.build_sharded_vm_packing(g, 2, g.neighbor_label_counts(),
                                     order=np.zeros(g.n, np.int64))
    with pytest.raises(ValueError, match="unknown shard_map_source"):
        psp.compute_shard_order(g, "spiral", 2)
    with pytest.raises(ValueError, match="needs a partition"):
        psp.compute_shard_order(g, "partition", 2)


@pytest.mark.parametrize("source", MAPS)
@pytest.mark.parametrize("n_shards", [1, 3])
def test_shard_csr_keeps_the_global_csr_order(n_shards, source):
    g, rg = _pair("musicbrainz_like", 700, 5)
    order = _order(source, rg, n_shards)
    sp = g.vm_packing_sharded(n_shards, block_n=64, block_e=128, order=order,
                              order_token=f"{source}:0")
    glob = g.vm_csr()
    g_dst = np.repeat(np.arange(g.n), np.diff(glob.row_ptr))
    seen = 0
    for s in range(n_shards):
        for ex in ("sliced", "psum"):
            csr = csr_from_shard(sp, s, ex)
            assert csr.row_ptr.shape == (sp.n_local_pad + 1,)
            slots = csr.order
            assert _eq(slots, np.nonzero(sp.slot_raw[s] >= 0)[0].astype(np.int64))
            src_map = sp.src_map_sliced if ex == "sliced" else sp.src_map
            assert _eq(csr.src, src_map[s, slots])
        rows = np.repeat(np.arange(sp.n_local_pad), np.diff(csr.row_ptr))
        # local row -> destination vertex through the shard map
        dst = sp.vtx_at[s * sp.n_local_pad + rows]
        assert _eq(dst.astype(np.int32), sp.dst_global[s, slots])
        # each destination's sources in the global CSR's order
        src = sp.src_global[s, slots]
        for v in np.unique(dst)[:50]:
            assert _eq(src[dst == v], glob.src[g_dst == v])
        seen += slots.size
    assert seen == g.m
    with pytest.raises(ValueError, match="unknown halo exchange"):
        csr_from_shard(sp, 0, "ring")


def test_mutation_patches_or_drops_every_cached_kind():
    """A graph holding each kind of cached entry — the graph's counts, the
    dst-sorted CSR, two block packings and two sharded packings — across a
    mutation: counts and packings patched, the CSR re-derived, the sharded
    packings patched in place; all equal to a fresh graph's."""
    g, _ = _pair("musicbrainz_like", 600, 2)
    g.cached_neighbor_label_counts()
    g.vm_csr()
    g.vm_packing()
    g.vm_packing(block_n=64, block_e=128)
    sp = g.vm_packing_sharded(2)
    sp3 = g.vm_packing_sharded(3, block_n=64, block_e=128)
    kinds = sorted(LabelledGraph._cache_kind(k) for k in g._vm_pack_cache)
    assert kinds == ["counts", "csr", "packing", "packing", "sharded", "sharded"]
    g.apply_mutations(MutationBatch(add_edges=[(0, 1), (1, 2), (2, 3)],
                                    remove_edges=[(int(g.src[0]), int(g.dst[0]))]))
    assert "csr" not in g._vm_pack_cache
    assert g.vm_packing_sharded(2) is sp and sp.version == g.version
    assert g.vm_packing_sharded(3, block_n=64, block_e=128) is sp3
    fresh = LabelledGraph(n=g.n, labels=g.labels.copy(),
                          label_names=list(g.label_names), src=g.src.copy(),
                          dst=g.dst.copy())
    assert _eq(g.cached_neighbor_label_counts(), fresh.neighbor_label_counts())
    for bn, be in ((128, 256), (64, 128)):
        a, b = g.vm_packing(block_n=bn, block_e=be), fresh.vm_packing(block_n=bn, block_e=be)
        for x, y in zip(a[1:], b[1:]):
            assert _eq(x, y)
        for name in ("src", "dst_local", "meta", "pad_mask", "order"):
            assert _eq(getattr(a[0], name), getattr(b[0], name)), name
    a, b = g.vm_csr(), fresh.vm_csr()
    for name in ("row_ptr", "src", "order"):
        assert _eq(getattr(a, name), getattr(b, name)), name
    for p, S, kw in ((sp, 2, {}), (sp3, 3, dict(block_n=64, block_e=128))):
        scratch = psp.build_sharded_vm_packing(
            fresh, S, fresh.neighbor_label_counts(), **kw)
        for x, y in zip(_canon(p), _canon(scratch)):
            assert _eq(x, y)
    with pytest.raises(KeyError, match="unknown vm packing cache key"):
        LabelledGraph._cache_kind(("other", 1))
