"""The port's dynamic graph against the JAX reference.

The same seeded ``MutationBatch``es go into ``repro.graphs.graph`` and
``repro_torch.graphs.graph``: the graph arrays, ``version``, the reverse
index, the neighbour-label counts, every ``AppliedMutation`` field, the
``vm_packing`` entries, ``compose_mutations``, the compacted log and its
``mutation_log_state`` are bitwise the reference's.  The port's own twins of
``tests/test_dynamic_graph.py`` hold every patched cache (the dst-sorted
``vm_csr`` and its row plan included) equal to a graph rebuilt from
scratch, and the plain field on a mutated graph equals the reference's
``jnp`` field bitwise."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core.rpq import parse_rpq as r_parse
from repro.core.tpstry import TPSTry as RTPSTry
from repro.core.visitor import extroversion_field as r_field
from repro.graphs import generators as rgen
from repro.graphs.graph import MutationBatch as RMutationBatch
from repro.graphs.graph import compose_mutations as r_compose
from repro.graphs.graph import mutation_log_state as r_log_state
from repro.graphs.partition import hash_partition

from repro_torch.convert import from_reference_arrays
from repro_torch.core.rpq import parse_rpq
from repro_torch.core.taper import Taper, TaperConfig
from repro_torch.core.tpstry import TPSTry
from repro_torch.core.visitor import _field, extroversion_field
from repro_torch.graphs.generators import (musicbrainz_like, paper_example_graph,
                                           power_law_labelled)
from repro_torch.graphs.graph import (AppliedMutation, LabelledGraph, MutationBatch,
                                      compose_mutations, mutation_log_from_state,
                                      mutation_log_state)
from repro_torch.workload.executor import QueryExecutor

APPLIED_ARRAYS = ("added_src", "added_dst", "removed_src", "removed_dst",
                  "old2new", "new_edge_pos", "relabel_v", "relabel_old",
                  "relabel_new")
APPLIED_SCALARS = ("version", "version_base", "n_before", "n_after", "is_noop")
OUTPUTS = ("alpha", "pr", "edge_mass", "extro_mass", "extroversion", "ext_to")


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _rebuilt(g: LabelledGraph) -> LabelledGraph:
    """Fresh graph constructed from g's raw arrays (full re-sort path)."""
    return LabelledGraph(
        n=g.n, labels=g.labels.copy(), label_names=list(g.label_names),
        src=g.src.copy(), dst=g.dst.copy())


def _same_csr(a, b):
    assert a.src_bound == b.src_bound
    for name in ("row_ptr", "src", "order"):
        assert _eq(getattr(a, name), getattr(b, name)), name
    assert _eq(a.plan.runs, b.plan.runs) and _eq(a.plan.long_rows, b.plan.long_rows)


def _assert_full_parity(g: LabelledGraph, queries=()):
    """Every incrementally-maintained structure == scratch rebuild, bitwise."""
    g2 = _rebuilt(g)
    assert np.array_equal(g.src, g2.src)
    assert np.array_equal(g.dst, g2.dst)
    assert np.array_equal(g.row_ptr, g2.row_ptr)
    assert np.array_equal(g.reverse_edge_index, g2.reverse_edge_index)
    assert np.array_equal(
        g.cached_neighbor_label_counts(), g2.neighbor_label_counts())
    p1, dl1, ic1, dg1 = g.vm_packing()
    p2, dl2, ic2, dg2 = g2.vm_packing()
    assert p1.n_blocks_out == p2.n_blocks_out
    for a, b in [
        (p1.src, p2.src), (p1.dst_local, p2.dst_local), (p1.meta, p2.meta),
        (p1.pad_mask, p2.pad_mask), (p1.order, p2.order),
        (dl1, dl2), (ic1, ic2), (dg1, dg2),
    ]:
        assert np.array_equal(np.asarray(a), np.asarray(b))
    _same_csr(g.vm_csr(), g2.vm_csr())
    for ex, q in queries:
        assert np.array_equal(ex.traversals(q), QueryExecutor(g).traversals(q))


def _seed_caches(g):
    g.reverse_edge_index
    g.cached_neighbor_label_counts()
    g.vm_packing()


@pytest.fixture
def paper_copy():
    return paper_example_graph().subgraph_mask(np.ones(6, bool))


# ---------------------------------------------------------------------------
# the port against the reference, batch by batch
# ---------------------------------------------------------------------------


def _pair(gen, n, seed, **kw):
    rg = getattr(rgen, gen)(n, seed=seed, **kw)
    g = from_reference_arrays(graph=dict(
        n=rg.n, labels=rg.labels, label_names=rg.label_names, src=rg.src,
        dst=rg.dst)).graph
    return g, rg


def _same_applied(a: AppliedMutation, ra) -> None:
    for name in APPLIED_ARRAYS:
        assert _eq(getattr(a, name), getattr(ra, name)), name
    for name in APPLIED_SCALARS:
        assert getattr(a, name) == getattr(ra, name), name
    assert _eq(a.dirty_vertices(), ra.dirty_vertices())


def _same_log(g, rg) -> None:
    arrays, meta = mutation_log_state(g.mutation_log)
    r_arrays, r_meta = r_log_state(rg.mutation_log)
    assert meta == r_meta and arrays.keys() == r_arrays.keys()
    for key in arrays:
        assert _eq(arrays[key], r_arrays[key]), key


def _same_graph(g, rg) -> None:
    assert (g.n, g.m, g.version) == (rg.n, rg.m, rg.version)
    for name in ("labels", "src", "dst", "row_ptr"):
        assert _eq(getattr(g, name), getattr(rg, name)), name
    assert _eq(g.reverse_edge_index, rg.reverse_edge_index)
    assert _eq(g.cached_neighbor_label_counts(), rg.cached_neighbor_label_counts())
    p, dl, ic, dg = g.vm_packing()
    rp, rdl, ric, rdg = rg.vm_packing()
    assert (p.n_blocks_out, p.block_n, p.block_e) == (
        rp.n_blocks_out, rp.block_n, rp.block_e)
    for name in ("src", "dst_local", "meta", "pad_mask", "order"):
        assert _eq(getattr(p, name), getattr(rp, name)), name
    assert _eq(dl, rdl) and _eq(ic, ric) and _eq(dg, rdg)
    _same_log(g, rg)


def _both(g, rg, **batch):
    """Apply one batch to both graphs; the records must agree."""
    a = g.apply_mutations(MutationBatch(**batch))
    ra = rg.apply_mutations(RMutationBatch(**batch))
    _same_applied(a, ra)
    return a


def _random_spec(g, rng, nv, na, nr, rem_v, nrl):
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
        remove_vertices=rem_v,
        relabel=(np.stack([rng.integers(0, hi, nrl),
                           rng.integers(0, g.n_labels, nrl)], 1)
                 if nrl else np.zeros((0, 2), np.int64)))


@pytest.mark.parametrize("seed", range(4))
def test_random_batches_equal_reference(seed):
    """Seeded mixed batches (added vertices and edges, removals, tombstones,
    relabels, self loops, duplicates): every record, array, cache and the
    log equal the reference's."""
    rng = np.random.default_rng(100 + seed)
    g, rg = _pair("power_law_labelled", int(rng.integers(60, 240)), seed,
                  n_labels=4, avg_degree=5.0)
    _seed_caches(g)
    _seed_caches(rg)
    for _ in range(4):
        rem_v = [int(rng.integers(0, g.n))] if rng.random() < 0.5 else []
        _both(g, rg, **_random_spec(
            g, rng, nv=int(rng.integers(0, 5)), na=int(rng.integers(0, 13)),
            nr=int(rng.integers(0, 13)), rem_v=rem_v, nrl=int(rng.integers(0, 4))))
        _same_graph(g, rg)


def test_edge_cases_equal_reference():
    """Self loops, duplicates, absent removals, a no-op batch (no version
    bump), a vertex relabelled twice in one batch, a relabel of a same-batch
    vertex, and an out-of-range endpoint (ValueError on both)."""
    g, rg = _pair("musicbrainz_like", 300, 2)
    _seed_caches(g)
    _seed_caches(rg)
    e0 = (int(g.src[0]), int(g.dst[0]))
    noop = _both(g, rg, add_edges=[e0], remove_edges=[(0, 0)])
    assert noop.is_noop and g.version == 0 and not g.mutation_log
    _both(g, rg, add_edges=[(5, 5), (1, 7), (7, 1), (1, 7)], remove_edges=[e0])
    _both(g, rg, add_vertex_labels=[1, 2], add_edges=[(300, 3), (301, 300)],
          relabel=[(4, 0), (4, 3), (301, 0)])
    _both(g, rg, relabel=[(5, int(g.labels[5]))], remove_vertices=[3])
    _same_graph(g, rg)
    for bad in (dict(add_edges=[(0, g.n)]), dict(relabel=[(0, g.n_labels)]),
                dict(remove_vertices=[g.n])):
        with pytest.raises(ValueError):
            g.apply_mutations(MutationBatch(**bad))
        with pytest.raises(ValueError):
            rg.apply_mutations(RMutationBatch(**bad))
    _same_graph(g, rg)


def test_compaction_and_compose_equal_reference():
    """Past MUTATION_LOG_LIMIT the two oldest records compose: the head
    record, every span and compose_mutations itself equal the reference's;
    the log survives a mutation_log_state round trip."""
    g, rg = _pair("musicbrainz_like", 400, 6)
    assert LabelledGraph.MUTATION_LOG_LIMIT == type(rg).MUTATION_LOG_LIMIT
    rng = np.random.default_rng(3)
    applied, r_applied = [], []
    for _ in range(g.MUTATION_LOG_LIMIT + 5):
        spec = _random_spec(g, rng, nv=int(rng.integers(0, 3)), na=4, nr=3,
                            rem_v=[], nrl=int(rng.integers(0, 2)))
        applied.append(g.apply_mutations(MutationBatch(**spec)))
        r_applied.append(rg.apply_mutations(RMutationBatch(**spec)))
    assert len(g.mutation_log) == g.MUTATION_LOG_LIMIT
    for a, ra in zip(g.mutation_log, rg.mutation_log):
        _same_applied(a, ra)
    _same_graph(g, rg)
    _same_applied(compose_mutations(applied[-2], applied[-1]),
                  r_compose(r_applied[-2], r_applied[-1]))
    with pytest.raises(ValueError, match="adjacent"):
        compose_mutations(applied[-1], applied[-2])
    arrays, meta = mutation_log_state(g.mutation_log)
    for a, b in zip(mutation_log_from_state(arrays, meta), g.mutation_log):
        _same_applied(a, b)


def test_carried_graph_keeps_version_and_log():
    """convert carries a mutated reference graph's version and log: an
    executor on the port graph patches across the same records."""
    g, rg = _pair("musicbrainz_like", 500, 8)
    rng = np.random.default_rng(0)
    for _ in range(3):
        spec = _random_spec(rg, rng, nv=2, na=6, nr=4, rem_v=[], nrl=1)
        rg.apply_mutations(RMutationBatch(**spec))
    carried = from_reference_arrays(graph=dict(
        n=rg.n, labels=rg.labels, label_names=rg.label_names, src=rg.src,
        dst=rg.dst, version=rg.version,
        mutation_log=r_log_state(rg.mutation_log))).graph
    _same_graph(carried, rg)
    assert carried.mutation_log[0].version_base == 0


@pytest.mark.parametrize("seed", range(2))
def test_plain_field_on_mutated_graph_equals_jnp(seed):
    """The plain field over a mutated graph (patched counts, packing and
    CSR) equals the reference's jnp field bitwise; the kernel backend's
    delta chain with the plain vm_step over the patched CSR equals it too,
    and a Taper's device inputs follow the version."""
    g, rg = _pair("provgen_like", 700, 11 + seed)
    queries = ["Entity.(Entity)*.Entity", "Entity.Activity.(Agent)*"]
    w = [(parse_rpq(q), 0.5) for q in queries]
    rw = [(r_parse(q), 0.5) for q in queries]
    taper = Taper(g, 4, TaperConfig(field_backend="torch"), device="cpu")
    rng = np.random.default_rng(seed)
    for _ in range(2):
        arrays = TPSTry.from_workload(w).compile(g.label_names)
        part = hash_partition(g.n, 4, seed=seed)
        f = taper.field(part, arrays)
        assert taper._pre["_dev_key"][0] == g.version
        r = r_field(rg, RTPSTry.from_workload(rw).compile(rg.label_names),
                    part, 4, backend="jnp")
        for name in OUTPUTS:
            assert _eq(getattr(f, name), getattr(r, name)), name
        fresh = extroversion_field(_rebuilt(g), arrays, part, 4, device="cpu")
        for name in OUTPUTS:
            assert _eq(getattr(f, name), getattr(fresh, name)), name
        outs = [_field(g, arrays, part, 4, arrays.max_depth, {}, True, b,
                       torch.device("cpu")) for b in ("cuda", "torch")]
        for a, b in zip(*outs):
            assert torch.equal(a, b)
        _both(g, rg, **_random_spec(g, rng, nv=3, na=20, nr=15,
                                    rem_v=[int(rng.integers(0, g.n))], nrl=3))


# ---------------------------------------------------------------------------
# mutation semantics (twins of tests/test_dynamic_graph.py)
# ---------------------------------------------------------------------------


def test_add_and_remove_edges(paper_copy):
    g = paper_copy
    _seed_caches(g)
    m0, v0 = g.m, g.version
    applied = g.apply_mutations(MutationBatch(
        add_edges=[(0, 5)], remove_edges=[(1, 2)]))
    assert g.version == v0 + 1
    assert g.m == m0  # one undirected edge in, one out
    assert 5 in g.neighbors(0) and 2 not in g.neighbors(1)
    assert applied.added_src.size == 2 and applied.removed_src.size == 2
    _assert_full_parity(g)


def test_add_vertices_with_edges(paper_copy):
    g = paper_copy
    _seed_caches(g)
    applied = g.apply_mutations(MutationBatch(
        add_vertex_labels=[2, 0], add_edges=[(6, 0), (6, 7), (7, 3)]))
    assert g.n == 8 and applied.n_after == 8
    assert sorted(g.neighbors(6).tolist()) == [0, 7]
    assert g.labels[6] == 2 and g.labels[7] == 0
    assert np.isin(np.arange(6, 8), applied.dirty_vertices()).all()
    _assert_full_parity(g)


def test_remove_vertex_isolates_tombstone(paper_copy):
    g = paper_copy
    _seed_caches(g)
    lab = int(g.labels[1])
    g.apply_mutations(MutationBatch(remove_vertices=[1]))
    assert g.n == 6                       # slot remains
    assert g.neighbors(1).size == 0       # but isolated
    assert int(g.labels[1]) == lab        # label kept
    assert not np.isin(1, g.dst).any()
    _assert_full_parity(g)


def test_remove_vertex_drops_one_directional_in_arcs():
    g = LabelledGraph(
        n=4, labels=[0, 0, 1, 1], label_names=["a", "b"],
        src=np.array([0, 1, 2], dtype=np.int32),
        dst=np.array([1, 2, 3], dtype=np.int32))
    g.apply_mutations(MutationBatch(remove_vertices=[1]))
    assert not np.isin(1, g.src).any() and not np.isin(1, g.dst).any()
    assert g.m == 1  # only (2, 3) survives


def test_noop_batch_does_not_bump_version(paper_copy):
    g = paper_copy
    v0 = g.version
    applied = g.apply_mutations(MutationBatch(
        add_edges=[(0, 1)],          # already present
        remove_edges=[(0, 5)]))      # absent
    assert applied.is_noop and g.version == v0
    assert len(g.mutation_log) == 0


def test_out_of_range_add_edge_raises(paper_copy):
    with pytest.raises(ValueError, match="out of range"):
        paper_copy.apply_mutations(MutationBatch(add_edges=[(0, 6)]))


def test_duplicate_and_self_loop_additions_dropped(paper_copy):
    g = paper_copy
    m0 = g.m
    g.apply_mutations(MutationBatch(add_edges=[(0, 0), (0, 5), (5, 0)]))
    assert g.m == m0 + 2  # one undirected edge, stored twice
    _assert_full_parity(g)


def test_stale_vm_packing_and_csr_not_served(paper_copy):
    g = paper_copy
    _seed_caches(g)
    before, csr_before = g.vm_packing(), g.vm_csr()
    g.apply_mutations(MutationBatch(add_edges=[(0, 5)]))
    after, csr_after = g.vm_packing(), g.vm_csr()
    assert after[0].src.shape != before[0].src.shape or not np.array_equal(
        after[0].src, before[0].src)
    assert csr_after is not csr_before and csr_after.src.shape[0] == g.m
    _same_csr(csr_after, _rebuilt(g).vm_csr())


def test_relabel_patches_caches(paper_copy):
    g = paper_copy
    _seed_caches(g)
    v0 = g.version
    old = int(g.labels[2])
    new = (old + 1) % g.n_labels
    applied = g.apply_mutations(MutationBatch(relabel=[(2, new)]))
    assert g.version == v0 + 1
    assert int(g.labels[2]) == new
    assert np.array_equal(applied.relabel_v, [2])
    assert applied.relabel_old[0] == old and applied.relabel_new[0] == new
    assert 2 in applied.dirty_vertices()
    _assert_full_parity(g)


def test_relabel_same_label_is_noop(paper_copy):
    g = paper_copy
    v0 = g.version
    applied = g.apply_mutations(MutationBatch(relabel=[(3, int(g.labels[3]))]))
    assert applied.is_noop and g.version == v0
    assert len(g.mutation_log) == 0


def test_relabel_last_entry_wins_and_validates(paper_copy):
    g = paper_copy
    old = int(g.labels[1])
    new = (old + 1) % g.n_labels
    g.apply_mutations(MutationBatch(relabel=[(1, old), (1, new)]))
    assert int(g.labels[1]) == new
    with pytest.raises(ValueError, match="label range"):
        g.apply_mutations(MutationBatch(relabel=[(1, g.n_labels)]))
    with pytest.raises(ValueError, match="vertex id"):
        g.apply_mutations(MutationBatch(relabel=[(g.n, 0)]))


def test_relabel_mixed_with_structural_same_batch(paper_copy):
    g = paper_copy
    _seed_caches(g)
    g.apply_mutations(MutationBatch(
        add_vertex_labels=[0],
        add_edges=[(6, 1), (6, 4)],
        remove_edges=[(1, 2)],
        relabel=[(0, (int(g.labels[0]) + 1) % g.n_labels), (6, 1)]))
    assert int(g.labels[6]) == 1
    _assert_full_parity(g)


def test_relabel_executor_patch_matches_rebuild():
    g = musicbrainz_like(1200, seed=21)
    q = parse_rpq("Artist.Credit.Track.Medium")
    ex = QueryExecutor(g)
    ex.traversals(q)
    rng = np.random.default_rng(0)
    for _ in range(3):
        vs = rng.choice(g.n, size=5, replace=False)
        g.apply_mutations(MutationBatch(
            relabel=[(int(v), int(rng.integers(0, g.n_labels))) for v in vs]))
        assert np.array_equal(ex.traversals(q), QueryExecutor(g).traversals(q))


def test_relabel_executor_patch_across_compacted_log():
    g = musicbrainz_like(600, seed=22)
    q = parse_rpq("Area.Artist.(Artist|Label).Area")
    ex = QueryExecutor(g)
    ex.traversals(q)     # snapshot at version 0
    rng = np.random.default_rng(1)
    for _ in range(g.MUTATION_LOG_LIMIT + 4):
        v = int(rng.integers(0, g.n))
        g.apply_mutations(MutationBatch(
            relabel=[(v, int(rng.integers(0, g.n_labels)))],
            add_edges=[(int(rng.integers(0, g.n)), int(rng.integers(0, g.n)))]))
    assert len(g.mutation_log) == g.MUTATION_LOG_LIMIT
    assert np.array_equal(ex.traversals(q), QueryExecutor(g).traversals(q))


def test_executor_patch_matches_rebuild():
    g = musicbrainz_like(2000, seed=3)
    q = parse_rpq("Artist.Credit.Track.Medium")
    ex = QueryExecutor(g)
    ex.traversals(q)
    rng = np.random.default_rng(0)
    und = np.stack([g.src, g.dst], 1)
    und = und[und[:, 0] < und[:, 1]]
    g.apply_mutations(MutationBatch(
        add_vertex_labels=rng.integers(0, g.n_labels, 4),
        add_edges=np.stack([rng.integers(0, g.n + 4, 30),
                            rng.integers(0, g.n + 4, 30)], 1),
        remove_edges=und[rng.choice(len(und), 20, replace=False)]))
    assert np.array_equal(ex.traversals(q), QueryExecutor(g).traversals(q))


def test_executor_patch_across_multiple_batches():
    g = musicbrainz_like(1500, seed=4)
    q = parse_rpq("Area.Artist.(Artist|Label).Area")
    ex = QueryExecutor(g)
    ex.traversals(q)
    rng = np.random.default_rng(1)
    for _ in range(3):  # gap of 3 versions, patched in one composed hop
        g.apply_mutations(MutationBatch(
            add_edges=np.stack([rng.integers(0, g.n, 15),
                                rng.integers(0, g.n, 15)], 1)))
    assert np.array_equal(ex.traversals(q), QueryExecutor(g).traversals(q))


def test_executor_patches_across_compacted_log():
    g = musicbrainz_like(1000, seed=5)
    q = parse_rpq("Artist.Credit.Track.Medium")
    ex = QueryExecutor(g)
    ex.traversals(q)
    rng = np.random.default_rng(2)
    for _ in range(g.MUTATION_LOG_LIMIT + 2):  # overflow the ring
        g.apply_mutations(MutationBatch(
            add_edges=np.stack([rng.integers(0, g.n, 4),
                                rng.integers(0, g.n, 4)], 1)))
    assert len(g.mutation_log) == g.MUTATION_LOG_LIMIT
    assert g.mutation_log[0].version_base == 0  # history still rooted
    assert ex._cache[q.qhash].version == 0      # consumer genuinely stale
    assert ex._covering_mutations(0) is not None
    assert np.array_equal(ex.traversals(q), QueryExecutor(g).traversals(q))


def test_mutation_log_compaction_ring_and_spans():
    g = musicbrainz_like(600, seed=6)
    rng = np.random.default_rng(3)
    total = g.MUTATION_LOG_LIMIT + 7
    for _ in range(total):
        g.apply_mutations(MutationBatch(
            add_edges=np.stack([rng.integers(0, g.n, 3),
                                rng.integers(0, g.n, 3)], 1)))
    log = g.mutation_log
    assert len(log) == g.MUTATION_LOG_LIMIT
    assert log[0].version_base == 0
    for a, b in zip(log, log[1:]):
        assert b.version_base == a.version
    assert log[-1].version == g.version == total
    assert log[0].version - log[0].version_base == total - (
        g.MUTATION_LOG_LIMIT - 1)


def test_executor_rebuilds_when_inside_compacted_span():
    g = musicbrainz_like(800, seed=7)
    q = parse_rpq("Artist.Credit.Track.Medium")
    rng = np.random.default_rng(4)
    g.apply_mutations(MutationBatch(
        add_edges=np.stack([rng.integers(0, g.n, 3),
                            rng.integers(0, g.n, 3)], 1)))
    ex = QueryExecutor(g)
    ex.traversals(q)                           # snapshot at version 1
    for _ in range(g.MUTATION_LOG_LIMIT + 3):  # version 1 gets compacted over
        g.apply_mutations(MutationBatch(
            add_edges=np.stack([rng.integers(0, g.n, 3),
                                rng.integers(0, g.n, 3)], 1)))
    assert g.mutation_log[0].version_base == 0
    assert g.mutation_log[0].version > 1
    assert ex._covering_mutations(1) is None
    assert np.array_equal(ex.traversals(q), QueryExecutor(g).traversals(q))


def test_compacted_record_bounded_under_same_edge_churn():
    g = musicbrainz_like(1000, seed=9)
    q = parse_rpq("Artist.Credit.Track.Medium")
    ex = QueryExecutor(g)
    ex.traversals(q)
    und = np.stack([g.src, g.dst], 1)
    fixed = und[und[:, 0] < und[:, 1]][:5]
    sizes = []
    for _ in range(3 * g.MUTATION_LOG_LIMIT):
        g.apply_mutations(MutationBatch(add_edges=fixed, remove_edges=fixed))
        sizes.append(int(g.mutation_log[0].removed_src.size))
    assert sizes[-1] == sizes[2 * g.MUTATION_LOG_LIMIT]  # plateaued
    assert sizes[-1] <= 2 * len(fixed) * 2
    assert np.array_equal(ex.traversals(q), QueryExecutor(g).traversals(q))


def test_compose_mutations_exact_roundtrip():
    g = musicbrainz_like(500, seed=8)
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(2):
        und = np.stack([g.src, g.dst], 1)
        und = und[und[:, 0] < und[:, 1]]
        batches.append(g.apply_mutations(MutationBatch(
            add_vertex_labels=rng.integers(0, g.n_labels, 2),
            add_edges=np.stack([rng.integers(0, g.n + 2, 8),
                                rng.integers(0, g.n + 2, 8)], 1),
            remove_edges=und[rng.choice(len(und), 5, replace=False)])))
    a, b = batches
    c = compose_mutations(a, b)
    assert c.version_base == a.version_base and c.version == b.version
    assert c.n_before == a.n_before and c.n_after == b.n_after
    valid = a.old2new >= 0
    expect = np.full(a.old2new.shape[0], -1, np.int64)
    expect[valid] = b.old2new[a.old2new[valid]]
    assert np.array_equal(c.old2new, expect)
    covered = np.zeros(g.m, bool)
    covered[c.old2new[c.old2new >= 0]] = True
    covered[c.new_edge_pos] = True
    assert covered.all()
    assert np.array_equal(g.src[c.new_edge_pos], c.added_src)
    assert np.array_equal(g.dst[c.new_edge_pos], c.added_dst)


@pytest.mark.parametrize("seed", range(8))
def test_random_mutation_batches_bitwise_parity(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(40, 250))
    g = power_law_labelled(n, n_labels=4, avg_degree=5.0, seed=seed)
    q = parse_rpq("L0.(L1|L2).L3")
    _seed_caches(g)
    ex = QueryExecutor(g)
    ex.traversals(q)
    for _ in range(int(rng.integers(1, 4))):
        rem_v = [int(rng.integers(0, g.n))] if rng.random() < 0.5 else []
        g.apply_mutations(MutationBatch(**_random_spec(
            g, rng, nv=int(rng.integers(0, 5)), na=int(rng.integers(0, 13)),
            nr=int(rng.integers(0, 13)), rem_v=rem_v,
            nrl=int(rng.integers(0, 4)))))
        g.validate()
        _assert_full_parity(g, queries=[(ex, q)])


def test_copy_and_stats():
    g = musicbrainz_like(300, seed=1)
    g.apply_mutations(MutationBatch(add_edges=[(0, 299)]))
    c = g.copy()
    assert c.version == 0 and not c.mutation_log and c.m == g.m
    assert c.undirected_edge_count() == g.m // 2 and c.is_symmetric()
    s = c.stats()
    assert s["n"] == 300 and s["m_undirected"] == g.m // 2
