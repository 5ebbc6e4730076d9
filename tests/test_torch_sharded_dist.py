"""The port's sharded field on several gloo ranks (spawned processes, one
``FileStore`` under ``tmp_path``), against the port's single-device field
and the JAX reference.

Each spawn runs many cases inside its ranks, which return their results to
the parent: at ``S = 3`` and ``S = 8`` every shard map under both
exchanges; at ``S = 3`` also a mutation sequence with dirty-shard
re-uploads and one ``Taper.invoke`` on the fig7 settings at N=2000.  Every
rank's field equals the port's ``torch`` field bit for bit and lies within
the reference suite's tolerance of the reference's ``jnp`` field; the halo
statistics are those the reference's packing gives."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core.rpq import parse_rpq as r_parse
from repro.core.tpstry import TPSTry as RTPSTry
from repro.core.visitor import extroversion_field as r_field
from repro.graphs import generators as rgen
from repro.graphs.graph import MutationBatch as RMutationBatch
from repro.graphs.partition import hash_partition, metis_like_partition
from repro.graphs.sharded_packing import compute_shard_order as r_shard_order
from repro.workload.executor import QueryExecutor as RQueryExecutor

from repro_torch.convert import from_reference_arrays
from repro_torch.core.rpq import parse_rpq
from repro_torch.core.tpstry import TPSTry
from repro_torch.core.visitor import extroversion_field
from repro_torch.graphs.graph import MutationBatch
from repro_torch.launch.mesh import run_ranks

FIELDS = ("alpha", "pr", "edge_mass", "extro_mass", "extroversion", "ext_to")
MQ1, MQ3 = "Area.Artist.(Artist|Label).Area", "Artist.Credit.Track.Medium"
MAPS = ("stripe", "partition", "bfs")
EXCHANGES = ("sliced", "psum")
PQ = ["Entity.(Entity)*.Entity", "Agent.Activity.Entity.Entity.Activity.Agent",
      "(Entity)*.Activity.Entity", "Entity.Activity.(Agent)*"]
PQ_FREQ = (0.4, 0.2, 0.2, 0.2)
#: fig7 provgen at N=2000, k=8, hash start (seed 1): the reference's series
FIG7_PROVGEN = [1634056, 1354268, 1202249, 1031948, 970273, 933984, 913087,
                911654, 908300]


def _graph(gen, n, seed):
    """The reference's generator's graph, carried into the port."""
    rg = getattr(rgen, gen)(n, seed=seed)
    g = from_reference_arrays(graph=dict(
        n=rg.n, labels=rg.labels, label_names=rg.label_names, src=rg.src,
        dst=rg.dst)).graph
    return g, rg


def _arrays(g, queries=(MQ1, MQ3), freqs=(0.5, 0.5)):
    w = [(parse_rpq(q), f) for q, f in zip(queries, freqs)]
    return TPSTry.from_workload(w).compile(g.label_names)


def _out(fld):
    return {f: getattr(fld, f) for f in FIELDS}


def _batches(seed=1, steps=3):
    """Seeded mutation batches over musicbrainz_like(1500, seed=23), and a
    local one."""
    g, _ = _graph("musicbrainz_like", 1500, 23)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        batch = dict(
            add_vertex_labels=[int(rng.integers(0, g.n_labels))],
            add_edges=np.stack([rng.integers(0, g.n, 8),
                                rng.integers(0, g.n, 8)], 1),
            remove_edges=[(int(g.src[i]), int(g.dst[i]))
                          for i in rng.integers(0, g.m, 4)])
        g.apply_mutations(MutationBatch(**batch))
        out.append(batch)
    # edges among the first vertices only: under the stripe map they dirty
    # the first shard alone
    out.append(dict(add_edges=[(1, 5), (2, 9), (3, 40)]))
    return out


def _grown(part, batch):
    """The partition extended over a batch's new vertices (into part 0)."""
    new = len(batch.get("add_vertex_labels", ()))
    return np.concatenate([part, np.zeros(new, np.int32)]).astype(np.int32)


# ---------------------------------------------------------------------------
# what each rank runs (module level: the spawned ranks import it by name)
# ---------------------------------------------------------------------------


def _rank_fields(rank, n_ranks):
    """Every shard map under both exchanges on one graph."""
    g, rg = _graph("musicbrainz_like", 900, 41)
    arrays = _arrays(g)
    part = metis_like_partition(rg, 4, seed=0)
    out = {}
    for source in MAPS:
        for exchange in EXCHANGES:
            pre = {}
            fld = extroversion_field(g, arrays, part, 4, _precomputed=pre,
                                     backend="torch_sharded", device="cpu",
                                     shard_map_source=source,
                                     halo_exchange=exchange)
            out[source, exchange] = (_out(fld), pre["_halo_stats"],
                                     pre["_shard_uploads"],
                                     pre["_shard_exchange"]["transport"])
    return out


def _rank_mutations(rank, n_ranks, batches):
    """A field before and after each mutation batch on one cached packing;
    which shards this rank re-uploaded each time."""
    g, _ = _graph("musicbrainz_like", 1500, 23)
    g.reverse_edge_index
    arrays = _arrays(g)
    part = hash_partition(g.n, 4, seed=4)
    pre = {"cnt": g.cached_neighbor_label_counts()}
    steps = [_out(extroversion_field(g, arrays, part, 4, _precomputed=pre,
                                     backend="torch_sharded", device="cpu",
                                     halo_exchange="sliced"))]
    uploads, reuploaded = [dict(pre["_shard_uploads"])], []
    for batch in batches:
        shard = pre["_shard_dev"]["shard"]
        epochs = pre["_shard_dev"]["sp"].shard_epoch.copy()
        g.apply_mutations(MutationBatch(**batch))
        pre["cnt"] = g.cached_neighbor_label_counts()
        part = _grown(part, batch)
        steps.append(_out(extroversion_field(
            g, arrays, part, 4, _precomputed=pre, backend="torch_sharded",
            device="cpu", halo_exchange="sliced")))
        sp = pre["_shard_dev"]["sp"]
        uploads.append(dict(pre["_shard_uploads"]))
        reuploaded.append((pre["_shard_dev"]["shard"] is not shard,
                           bool(sp.shard_epoch[rank] != epochs[rank])))
    return steps, uploads, reuploaded


def _rank_fig7(rank, n_ranks):
    """One invocation on fig7's provgen settings at N=2000, partition map,
    sliced exchange: every rank runs it in full."""
    from repro_torch.core.taper import Taper, TaperConfig
    from repro_torch.graphs.generators import provgen_like
    from repro_torch.graphs.partition import hash_partition as p_hash

    g = provgen_like(2000, avg_degree=6.0, seed=11)
    w = [(parse_rpq(q), f) for q, f in zip(PQ, PQ_FREQ)]
    taper = Taper(g, 8, TaperConfig(max_iterations=8, seed=0,
                                    field_backend="torch_sharded",
                                    shard_map_source="partition"), device="cpu")
    rep = taper.invoke(p_hash(g.n, 8, seed=1), w)
    return rep.parts, rep.halo_stats


def _rank_s3(rank, n_ranks, batches):
    return (_rank_fields(rank, n_ranks),
            _rank_mutations(rank, n_ranks, batches),
            _rank_fig7(rank, n_ranks))


# ---------------------------------------------------------------------------
# the parent's checks
# ---------------------------------------------------------------------------


def _same(got, want):
    for f in FIELDS:
        assert got[f].dtype == want[f].dtype and np.array_equal(got[f], want[f]), f


def _close(ref, got):
    for f in FIELDS:
        np.testing.assert_allclose(got[f], getattr(ref, f), atol=2e-5,
                                   rtol=1e-4, err_msg=f)


def _halo_stats(sp, source, exchange, n, n_trie, max_depth):
    """The reference field's ``_halo_stats`` for packing ``sp``
    (src/repro/core/visitor.py:638-654)."""
    full = sp.full_field_bytes_per_depth(n, n_trie)
    halo = sp.halo_bytes_per_depth(n_trie, exchange=exchange)
    return {"halo_bytes_per_depth": halo, "full_field_bytes_per_depth": full,
            "halo_ratio": halo / max(full, 1), "shard_map_source": source,
            "halo_exchange": exchange, "n_shards": sp.n_shards,
            "n_frontier": sp.n_frontier, "hot_rows": sp.hot_pad,
            "sliced_rows": sp.hot_pad + int(sp.round_cap[1:].sum()),
            "depth_steps": max(int(max_depth) - 1, 0)}


def _check_fields(results, n_ranks):
    g, rg = _graph("musicbrainz_like", 900, 41)
    arrays = _arrays(g)
    r_arrays = RTPSTry.from_workload([(r_parse(MQ1), 0.5), (r_parse(MQ3), 0.5)]
                                     ).compile(rg.label_names)
    part = metis_like_partition(rg, 4, seed=0)
    plain = _out(extroversion_field(g, arrays, part, 4, backend="torch",
                                    device="cpu"))
    ref = r_field(rg, r_arrays, part, 4, backend="jnp")
    for source in MAPS:
        order = r_shard_order(rg, source, n_ranks, part=part)
        token = "stripe" if order is None else f"{source}:0"
        sp = rg.vm_packing_sharded(n_ranks, order=order, order_token=token)
        want = _halo_stats(sp, source, "sliced", g.n, arrays.n_nodes,
                           arrays.max_depth)
        for exchange in EXCHANGES:
            want.update(_halo_stats(sp, source, exchange, g.n, arrays.n_nodes,
                                    arrays.max_depth))
            for rank_out in results:
                fld, stats, uploads, transport = rank_out[source, exchange]
                _same(fld, plain)
                assert stats == want
                assert uploads == {"last_shards": n_ranks, "total_shards": n_ranks,
                                   "rebuilds": 1}
                assert transport == "gloo"
            _close(ref, results[0][source, exchange][0])
        if n_ranks > 1 and source == "partition":
            # the partition map moves fewer halo bytes than the stripe
            assert results[0]["partition", "sliced"][1]["halo_bytes_per_depth"] <= \
                results[0]["stripe", "psum"][1]["halo_bytes_per_depth"]


@pytest.mark.parametrize("n_ranks", [3])
def test_three_ranks_fields_mutations_and_fig7(n_ranks, tmp_path):
    batches = _batches()
    results = run_ranks(_rank_s3, n_ranks, tmp_path, args=(batches,))
    _check_fields([r[0] for r in results], n_ranks)

    # mutation sequence: every step bitwise the plain field (and within the
    # reference's tolerance of its jnp field); the packing was patched, and
    # a rank re-uploaded its shard exactly when its shard's epoch moved
    g, rg = _graph("musicbrainz_like", 1500, 23)
    g.reverse_edge_index
    arrays = _arrays(g)
    r_arrays = RTPSTry.from_workload([(r_parse(MQ1), 0.5), (r_parse(MQ3), 0.5)]
                                     ).compile(rg.label_names)
    part = hash_partition(g.n, 4, seed=4)
    want = [(_out(extroversion_field(g, arrays, part, 4, backend="torch",
                                     device="cpu")),
             r_field(rg, r_arrays, part, 4, backend="jnp"))]
    for batch in batches:
        g.apply_mutations(MutationBatch(**batch))
        rg.apply_mutations(RMutationBatch(**batch))
        part = _grown(part, batch)
        want.append((_out(extroversion_field(g, arrays, part, 4, backend="torch",
                                             device="cpu")),
                     r_field(rg, r_arrays, part, 4, backend="jnp")))
    any_reupload = False
    for rank, (steps, uploads, reuploaded) in enumerate(r[1] for r in results):
        for got, (plain, ref) in zip(steps, want):
            _same(got, plain)
            _close(ref, got)
        assert uploads == results[0][1][1]               # the same counts
        assert all(u["rebuilds"] == 1 for u in uploads)  # patched, never rebuilt
        for did, epoch_moved in reuploaded:
            assert did == epoch_moved
            any_reupload |= did
    assert any_reupload
    assert any(u["last_shards"] < n_ranks for u in results[0][1][1][1:])

    # fig7 at N=2000 through the sharded field: the reference's series, and
    # the same partitions on every rank
    rg = rgen.provgen_like(2000, avg_degree=6.0, seed=11)
    r_ex = RQueryExecutor(rg)
    rw = [(r_parse(q), f) for q, f in zip(PQ, PQ_FREQ)]
    parts0, halo0 = results[0][2]
    assert [round(r_ex.workload_ipt(rw, p)) for p in parts0] == FIG7_PROVGEN
    for parts, halo in (r[2] for r in results):
        assert all(np.array_equal(a, b) for a, b in zip(parts, parts0))
        assert halo == halo0
    assert {h["n_shards"] for h in halo0} == {n_ranks}
    assert {h["shard_map_source"] for h in halo0} == {"partition"}


def test_eight_ranks_every_map_and_exchange(tmp_path):
    _check_fields(run_ranks(_rank_fields, 8, tmp_path), 8)
