"""The port's sharded field on one in-process gloo rank, against the port's
single-device field and the JAX reference.

``torch_sharded`` equals the port's ``torch`` field bit for bit in every
output, for every shard map and exchange, after mutation batches, and
inside ``Taper`` / ``OnlineTaper``; it is within the reference's own
tolerances (``tests/test_sharded_field.py``: atol 2e-5 / rtol 1e-4) of the
reference's ``jnp``, ``pallas`` and ``pallas_sharded`` fields (the latter
on one CPU device, Pallas in interpret mode, as the reference's tests run
it), and its ``_halo_stats`` / ``_shard_uploads`` are the reference's
dicts.  ``vm_step`` takes a halo-extended input (more rows than it
writes), as the reference's kernel does inside the sharded field.  The
twins with several ranks are in ``tests/test_torch_sharded_dist.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core.online import OnlinePolicy as ROnlinePolicy
from repro.core.online import OnlineTaper as ROnlineTaper
from repro.core.rpq import parse_rpq as r_parse
from repro.core.taper import Taper as RTaper
from repro.core.taper import TaperConfig as RTaperConfig
from repro.core.tpstry import TPSTry as RTPSTry
from repro.core.visitor import extroversion_field as r_field
from repro.graphs import generators as rgen
from repro.graphs.graph import MutationBatch as RMutationBatch
from repro.graphs.partition import hash_partition, metis_like_partition
from repro.kernels.vm_step.kernel import vm_step_packed as r_vm_step_packed
from repro.kernels.vm_step.ref import build_transition as r_build_transition

from repro_torch.convert import from_reference_arrays
from repro_torch.core.online import OnlinePolicy, OnlineTaper
from repro_torch.core.rpq import parse_rpq
from repro_torch.core.taper import Taper, TaperConfig
from repro_torch.core.tpstry import TPSTry
from repro_torch.core.visitor import extroversion_field
from repro_torch.graphs import generators as pgen
from repro_torch.graphs.graph import MutationBatch
from repro_torch.kernels.segment_spmm.ops import csr_from_shard
from repro_torch.kernels.vm_step.ops import vm_step
from repro_torch.kernels.vm_step.ref import transition_columns
from repro_torch.launch.mesh import make_smoke_group
from repro_torch.workload.executor import QueryExecutor

MQ1 = "Area.Artist.(Artist|Label).Area"
MQ3 = "Artist.Credit.Track.Medium"
FIELDS = ("alpha", "pr", "edge_mass", "extro_mass", "extroversion", "ext_to")
MQ = ["Area.Artist.(Artist|Label).Area",
      "Artist.Credit.(Track|Recording).Credit.Artist",
      "Artist.Credit.Track.Medium"]
PQ = ["Entity.(Entity)*.Entity", "Agent.Activity.Entity.Entity.Activity.Agent",
      "(Entity)*.Activity.Entity", "Entity.Activity.(Agent)*"]
#: fig7 at N=2000, k=8, hash start (seed 1): the reference's ipt series
#: (benchmarks/fig7_convergence.py; identical in BENCH_PR5..PR10.json)
FIG7 = {
    "provgen": ("provgen_like", 11, PQ, (0.4, 0.2, 0.2, 0.2),
                [1634056, 1354268, 1202249, 1031948, 970273, 933984, 913087,
                 911654, 908300]),
    "musicbrainz": ("musicbrainz_like", 13, MQ, (0.2, 0.3, 0.5),
                    [180425, 156093, 128261, 111282, 99870, 96681, 96536]),
}


def _pair(gen, n, seed, **kw):
    rg = getattr(rgen, gen)(n, seed=seed, **kw)
    g = from_reference_arrays(graph=dict(
        n=rg.n, labels=rg.labels, label_names=rg.label_names, src=rg.src,
        dst=rg.dst)).graph
    return g, rg


def _tries(g, queries=(MQ1, MQ3), freqs=(0.5, 0.5)):
    w = [(parse_rpq(q), f) for q, f in zip(queries, freqs)]
    rw = [(r_parse(q), f) for q, f in zip(queries, freqs)]
    return (TPSTry.from_workload(w).compile(g.label_names),
            RTPSTry.from_workload(rw).compile(g.label_names), w, rw)


def _bitwise(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if y is None:
            assert x is None, f
            continue
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.total_extroversion == b.total_extroversion


def _close(ref, sh, atol=2e-5):
    """The reference suite's tolerance (tests/test_sharded_field.py)."""
    for f in FIELDS:
        a, b = getattr(ref, f), getattr(sh, f)
        if a is None:
            assert b is None
            continue
        np.testing.assert_allclose(a, b, atol=atol, rtol=1e-4, err_msg=f)
    assert abs(ref.total_extroversion - sh.total_extroversion) <= max(
        1e-4, 1e-3 * abs(ref.total_extroversion))


def _sharded(g, arrays, part, k, pre=None, **kw):
    return extroversion_field(g, arrays, part, k, _precomputed=pre,
                              backend="torch_sharded", device="cpu", **kw)


def _plain(g, arrays, part, k, **kw):
    return extroversion_field(g, arrays, part, k, backend="torch",
                              device="cpu", **kw)


def test_smoke_group_is_one_gloo_rank():
    import torch.distributed as dist

    group = make_smoke_group("cpu")
    assert make_smoke_group("cpu") is group
    assert dist.get_world_size(group) == 1 and dist.get_backend(group) == "gloo"
    taper = Taper(pgen.musicbrainz_like(200, seed=1), 4,
                  TaperConfig(field_backend="torch_sharded"), device="cpu")
    assert taper._group_shards() == 1


@pytest.mark.parametrize("seed", range(4))
def test_sharded_field_parity_random_graphs(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(200, 900))
    g, rg = _pair("power_law_labelled", n, seed, n_labels=6)
    arrays, r_arrays, _, _ = _tries(g, ("L0.L1.(L2|L3).L1", "L1.L2.L0"), (0.6, 0.4))
    k = int(rng.integers(2, 9))
    part = hash_partition(g.n, k, seed=seed)
    sh = _sharded(g, arrays, part, k)
    _bitwise(sh, _plain(g, arrays, part, k))
    _close(r_field(rg, r_arrays, part, k, backend="jnp"), sh)


@pytest.mark.parametrize("dense_ext_to", [True, False])
def test_sharded_field_parity_dense_and_lazy(dense_ext_to):
    g, rg = _pair("musicbrainz_like", 1200, 11)
    arrays, r_arrays, _, _ = _tries(g)
    part = hash_partition(g.n, 8, seed=1)
    sh = _sharded(g, arrays, part, 8, dense_ext_to=dense_ext_to)
    _bitwise(sh, _plain(g, arrays, part, 8, dense_ext_to=dense_ext_to))
    _close(r_field(rg, r_arrays, part, 8, backend="jnp",
                   dense_ext_to=dense_ext_to), sh)


def test_sharded_field_parity_depth_cap():
    g, rg = _pair("musicbrainz_like", 800, 12)
    arrays, r_arrays, _, _ = _tries(g)
    part = hash_partition(g.n, 4, seed=2)
    for cap in (1, 2, 3):
        pre = {}
        sh = _sharded(g, arrays, part, 4, pre, depth_cap=cap)
        _bitwise(sh, _plain(g, arrays, part, 4, depth_cap=cap))
        _close(r_field(rg, r_arrays, part, 4, depth_cap=cap, backend="jnp"), sh)
        assert pre["_halo_stats"]["depth_steps"] == max(
            min(arrays.max_depth, cap) - 1, 0)


def test_sharded_field_parity_vs_pallas_single_device():
    g, rg = _pair("musicbrainz_like", 900, 13)
    arrays, r_arrays, _, _ = _tries(g)
    part = hash_partition(g.n, 8, seed=3)
    sh = _sharded(g, arrays, part, 8)
    _close(r_field(rg, r_arrays, part, 8, backend="pallas"), sh)


@pytest.mark.parametrize("source", ["stripe", "partition", "bfs"])
@pytest.mark.parametrize("exchange", ["psum", "sliced"])
def test_shard_maps_and_exchanges_equal_plain_and_reference(source, exchange):
    g, rg = _pair("musicbrainz_like", 900, 41)
    arrays, r_arrays, _, _ = _tries(g)
    part = metis_like_partition(rg, 4, seed=0)
    pre, r_pre = {}, {}
    sh = _sharded(g, arrays, part, 4, pre, shard_map_source=source,
                  halo_exchange=exchange)
    _bitwise(sh, _plain(g, arrays, part, 4))
    _close(r_field(rg, r_arrays, part, 4, backend="jnp"), sh)
    r_sh = r_field(rg, r_arrays, part, 4, _precomputed=r_pre,
                   backend="pallas_sharded", shard_map_source=source,
                   halo_exchange=exchange)
    _close(r_sh, sh)
    assert pre["_halo_stats"] == r_pre["_halo_stats"]
    assert pre["_shard_uploads"] == r_pre["_shard_uploads"]
    assert pre.get("_shard_order", ("stripe",))[0] == r_pre.get(
        "_shard_order", ("stripe",))[0]
    hs = pre["_halo_stats"]
    assert (hs["shard_map_source"], hs["halo_exchange"]) == (source, exchange)
    assert hs["halo_bytes_per_depth"] < hs["full_field_bytes_per_depth"]
    assert pre["_shard_exchange"]["transport"] == "gloo"


def test_switching_the_exchange_reuploads_one_csr_uncounted():
    """The shard's device inputs hold one exchange's CSR (and the plain
    step's rows only for ``torch_sharded``); a caller that switches the
    exchange gets the other CSR, and ``_shard_uploads`` counts as the
    reference's, which keeps both exchanges' tables on the device."""
    g, rg = _pair("musicbrainz_like", 500, 43)
    arrays, r_arrays, _, _ = _tries(g)
    part = metis_like_partition(rg, 4, seed=0)
    want = _plain(g, arrays, part, 4)
    pre, r_pre = {}, {}
    for exchange in ("sliced", "psum", "sliced"):
        _bitwise(_sharded(g, arrays, part, 4, pre, shard_map_source="partition",
                          halo_exchange=exchange), want)
        r_field(rg, r_arrays, part, 4, _precomputed=r_pre, backend="pallas_sharded",
                shard_map_source="partition", halo_exchange=exchange)
        shard = pre["_shard_dev"]["shard"]
        assert shard["kind"] == (exchange, True) and "rows" in shard
        sp = pre["_shard_dev"]["sp"]
        src_map = sp.src_map_sliced if exchange == "sliced" else sp.src_map
        slots = shard["slots"].numpy()
        assert np.array_equal(shard["csr"].src.numpy(), src_map[0, slots])
        assert pre["_shard_uploads"] == r_pre["_shard_uploads"]


def test_seeded_random_shard_map():
    g, _ = _pair("power_law_labelled", 400, 9, n_labels=5)
    arrays, _, _, _ = _tries(g, ("L0.L1.(L2|L3).L1", "L1.L2.L0"), (0.6, 0.4))
    part = hash_partition(g.n, 5, seed=9)
    for exchange in ("sliced", "psum"):
        pre = {"_shard_order": ("random:0", np.random.default_rng(3).permutation(g.n))}
        _bitwise(_sharded(g, arrays, part, 5, pre, halo_exchange=exchange),
                 _plain(g, arrays, part, 5))


def test_partition_map_sliced_exchange_compresses_halo():
    g, _ = _pair("musicbrainz_like", 2000, 13)
    from repro_torch.graphs.sharded_packing import partition_shard_order

    sp_stripe = g.vm_packing_sharded(8)
    order = partition_shard_order(metis_like_partition(g, 8, seed=0), 8)
    sp_part = g.vm_packing_sharded(8, order=order, order_token="partition:0")
    base = sp_stripe.halo_bytes_per_depth(16, exchange="psum")
    sliced = sp_part.halo_bytes_per_depth(16, exchange="sliced")
    assert sliced * 2 <= base
    assert sliced <= sp_part.halo_bytes_per_depth(16, exchange="psum")


def test_sharded_field_after_mutation_batches():
    g, rg = _pair("musicbrainz_like", 1500, 23)
    arrays, r_arrays, _, _ = _tries(g)
    part = hash_partition(g.n, 4, seed=4)
    pre, r_pre = {}, {}
    _sharded(g, arrays, part, 4, pre)
    r_field(rg, r_arrays, part, 4, _precomputed=r_pre, backend="pallas_sharded")
    rebuilds0 = pre["_shard_uploads"]["rebuilds"]
    g.reverse_edge_index, rg.reverse_edge_index
    rng = np.random.default_rng(1)
    for _ in range(3):
        batch = dict(
            add_vertex_labels=[int(rng.integers(0, g.n_labels))],
            add_edges=np.stack([rng.integers(0, g.n, 8),
                                rng.integers(0, g.n, 8)], 1),
            remove_edges=[(int(g.src[i]), int(g.dst[i]))
                          for i in rng.integers(0, g.m, 4)])
        g.apply_mutations(MutationBatch(**batch))
        rg.apply_mutations(RMutationBatch(**batch))
        part = np.concatenate([part, [0]]).astype(np.int32)
        sh = _sharded(g, arrays, part, 4, pre)
        _bitwise(sh, _plain(g, arrays, part, 4))
        r_sh = r_field(rg, r_arrays, part, 4, _precomputed=r_pre,
                       backend="pallas_sharded")
        _close(r_sh, sh)
        assert pre["_shard_uploads"] == r_pre["_shard_uploads"]
        assert pre["_halo_stats"] == r_pre["_halo_stats"]
    # the cached packing was patched, never rebuilt from scratch
    assert pre["_shard_uploads"]["rebuilds"] == rebuilds0


def test_capacity_overflow_rebuild_in_the_field():
    g, _ = _pair("musicbrainz_like", 400, 24)
    arrays, _, _, _ = _tries(g)
    part = hash_partition(g.n, 4, seed=4)
    pre = {}
    _sharded(g, arrays, part, 4, pre)
    sp = pre["_shard_dev"]["sp"]
    grow = sp.n_shards * sp.n_local_pad
    g.apply_mutations(MutationBatch(add_vertex_labels=np.zeros(grow, np.int64)))
    part = np.concatenate([part, np.zeros(grow, np.int32)])
    _bitwise(_sharded(g, arrays, part, 4, pre), _plain(g, arrays, part, 4))
    assert pre["_shard_uploads"]["rebuilds"] == 2
    assert pre["_shard_dev"]["sp"] is not sp


def test_vm_step_reads_a_halo_extended_input():
    """vm_step over one shard of the reference's packing: alpha holds the
    shard's rows then its exchanged halo rows (n_in > n_out), against the
    reference's Pallas kernel on the same buffer (interpret mode)."""
    g, rg = _pair("musicbrainz_like", 900, 41)
    _, r_arrays, _, _ = _tries(g)
    order = metis_like_partition(rg, 3, seed=0)
    from repro.graphs.sharded_packing import partition_shard_order

    sp = rg.vm_packing_sharded(3, block_n=64, block_e=128,
                               order=partition_shard_order(order, 3),
                               order_token="partition:0")
    T = r_build_transition(r_arrays.parent, r_arrays.label, r_arrays.cond_p,
                           r_arrays.n_labels)
    par, val = transition_columns(r_arrays.parent, r_arrays.label,
                                  r_arrays.cond_p, r_arrays.n_labels)
    rng = np.random.default_rng(5)
    for s in range(3):
        a_in = rng.random((sp.n_local_pad + sp.h_pad, r_arrays.n_nodes)).astype(np.float32)
        inv_local = sp.inv_cnt[s] * (rng.random(sp.e_pad) < 0.6)
        want = np.asarray(r_vm_step_packed(
            jnp.asarray(a_in), jnp.asarray(T), jnp.asarray(sp.src_map[s]),
            jnp.asarray(sp.dst_local[s]), jnp.asarray(sp.dst_label[s]),
            jnp.asarray(inv_local.astype(np.float32)), jnp.asarray(sp.meta[s]),
            sp.blocks_per_shard, sp.block_n, sp.block_e, interpret=True))
        csr = csr_from_shard(sp, s, "psum").to("cpu")
        got = vm_step(torch.from_numpy(a_in), torch.from_numpy(par),
                      torch.from_numpy(val), csr,
                      torch.from_numpy(inv_local[csr.order.numpy()].astype(np.float32)),
                      torch.from_numpy(np.maximum(sp.vlabels[s], 0).astype(np.int32)))
        assert got.shape == (sp.n_local_pad, r_arrays.n_nodes)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    # sources must lie below alpha's rows, labels come one per output row
    with pytest.raises(ValueError, match="indexes past"):
        vm_step(torch.from_numpy(a_in[: csr.src_bound - 1]), torch.from_numpy(par),
                torch.from_numpy(val), csr, torch.zeros(csr.src.shape[0]),
                torch.zeros(sp.n_local_pad, dtype=torch.int32))
    with pytest.raises(ValueError, match="one entry per output row"):
        vm_step(torch.from_numpy(a_in), torch.from_numpy(par),
                torch.from_numpy(val), csr, torch.zeros(csr.src.shape[0]),
                torch.zeros(a_in.shape[0], dtype=torch.int32))


def test_taper_invocation_with_sharded_backend():
    g, rg = _pair("musicbrainz_like", 1200, 31)
    w = [(parse_rpq(MQ1), 0.5), (parse_rpq(MQ3), 0.5)]
    rw = [(r_parse(MQ1), 0.5), (r_parse(MQ3), 0.5)]
    part0 = hash_partition(g.n, 4, seed=1)
    plain = Taper(g, 4, TaperConfig(max_iterations=3, seed=0),
                  device="cpu").invoke(part0, w)
    sh = Taper(g, 4, TaperConfig(max_iterations=3, seed=0,
                                 field_backend="torch_sharded"),
               device="cpu").invoke(part0, w)
    ref = RTaper(rg, 4, RTaperConfig(max_iterations=3, seed=0)).invoke(part0, rw)
    # the sharded field is the plain one's bits, so the swaps are the same
    assert sh.objective == plain.objective
    assert all(np.array_equal(a, b) for a, b in zip(sh.parts, plain.parts))
    assert all(np.array_equal(a, b) for a, b in zip(sh.parts, ref.parts))
    assert len(sh.halo_stats) == len(sh.field_seconds) and not plain.halo_stats
    assert sh.halo_stats[0]["n_shards"] == 1


def test_taper_config_psum_matches_sliced():
    g, _ = _pair("musicbrainz_like", 700, 44)
    w = [(parse_rpq(MQ1), 0.5), (parse_rpq(MQ3), 0.5)]
    part0 = hash_partition(g.n, 4, seed=1)
    reps = [Taper(g, 4, TaperConfig(max_iterations=2, seed=0,
                                    field_backend="torch_sharded",
                                    halo_exchange=ex), device="cpu").invoke(part0, w)
            for ex in ("sliced", "psum")]
    assert reps[0].objective == reps[1].objective
    assert [h["halo_exchange"] for h in reps[1].halo_stats] == ["psum"] * len(
        reps[1].halo_stats)


def test_online_taper_redeals_shards_on_commit():
    g, rg = _pair("musicbrainz_like", 1000, 33)
    cfg = dict(max_iterations=2, shard_map_source="partition")
    ot = OnlineTaper(g, 4, config=TaperConfig(field_backend="torch_sharded", **cfg),
                     policy=OnlinePolicy(cadence=2, min_interval=0), device="cpu")
    rot = ROnlineTaper(rg, 4, config=RTaperConfig(field_backend="pallas_sharded", **cfg),
                       policy=ROnlinePolicy(cadence=2, min_interval=0))
    ot.observe([parse_rpq(MQ1)] * 40)
    rot.observe([r_parse(MQ1)] * 40)
    rep, r_rep = ot.invoke(reason="manual"), rot.invoke(reason="manual")
    assert rep is not None and r_rep is not None
    pre, r_pre = ot.taper._pre, rot.taper._pre
    token, order = pre["_shard_order"]
    assert token == r_pre["_shard_order"][0] and token.startswith("partition:")
    assert np.array_equal(order, r_pre["_shard_order"][1])
    assert np.array_equal(np.sort(order), np.arange(g.n))
    assert pre["_halo_stats"]["shard_map_source"] == "partition"
    assert ot.taper._redeal_counter == rot.taper._redeal_counter
    # an unchanged partition skips the re-deal (no repacking churn)
    assert not ot.taper.maybe_redeal_shards(ot.part)
    assert not rot.taper.maybe_redeal_shards(rot.part)
    # a regrouped partition re-deals under a fresh token, as the reference's
    regrouped = np.random.default_rng(0).integers(0, 4, g.n).astype(np.int32)
    assert ot.taper.maybe_redeal_shards(regrouped, n_shards=4)
    assert rot.taper.maybe_redeal_shards(regrouped, n_shards=4)
    assert pre["_shard_order"][0] == r_pre["_shard_order"][0] != token
    assert np.array_equal(pre["_shard_order"][1], r_pre["_shard_order"][1])


def test_online_taper_with_sharded_backend_follows_the_reference():
    g, rg = _pair("musicbrainz_like", 1000, 32)
    ot = OnlineTaper(g, 4, config=TaperConfig(max_iterations=2,
                                              field_backend="torch_sharded"),
                     policy=OnlinePolicy(cadence=2, min_interval=0), device="cpu")
    plain = OnlineTaper(g.copy(), 4, config=TaperConfig(max_iterations=2),
                        policy=OnlinePolicy(cadence=2, min_interval=0), device="cpu")
    rot = ROnlineTaper(rg, 4, config=RTaperConfig(max_iterations=2),
                       policy=ROnlinePolicy(cadence=2, min_interval=0))
    for o in (ot, plain):
        o.observe([parse_rpq(MQ1)] * 40)
    rot.observe([r_parse(MQ1)] * 40)
    assert ot.invoke(reason="manual") is not None
    plain.invoke(reason="manual")
    rot.invoke(reason="manual")
    rng = np.random.default_rng(2)
    batch = dict(add_vertex_labels=[1, 2],
                 add_edges=np.stack([rng.integers(0, g.n + 2, 10),
                                     rng.integers(0, g.n + 2, 10)], 1))
    for o in (ot, plain):
        o.apply_mutations(MutationBatch(**batch))
        o.observe([parse_rpq(MQ3)] * 40)
    rot.apply_mutations(RMutationBatch(**batch))
    rot.observe([r_parse(MQ3)] * 40)
    steps = [o.step() for o in (ot, plain, rot)]
    assert len({s.invoked for s in steps}) == 1
    assert np.array_equal(ot.part, plain.part) and np.array_equal(ot.part, rot.part)
    assert ot.part.shape[0] == g.n and (ot.part >= 0).all() and (ot.part < 4).all()


@pytest.mark.parametrize("name", sorted(FIG7))
def test_fig7_with_the_sharded_field(name):
    gen, seed, queries, freqs, series = FIG7[name]
    g = getattr(pgen, gen)(2000, avg_degree=6.0, seed=seed)
    w = [(parse_rpq(q), f) for q, f in zip(queries, freqs)]
    taper = Taper(g, 8, TaperConfig(max_iterations=8, seed=0,
                                    field_backend="torch_sharded",
                                    shard_map_source="partition"), device="cpu")
    rep = taper.invoke(hash_partition(g.n, 8, seed=1), w)
    ex = QueryExecutor(g)
    assert rep.iterations == len(series) - 1
    assert [round(ex.workload_ipt(w, p)) for p in rep.parts] == series


def test_backend_and_exchange_are_checked():
    g, _ = _pair("musicbrainz_like", 300, 3)
    arrays, _, _, _ = _tries(g)
    part = hash_partition(g.n, 4, seed=1)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        extroversion_field(g, arrays, part, 4, backend="cuda_sharded", device="cpu")
    with pytest.raises(ValueError, match="unknown halo exchange"):
        extroversion_field(g, arrays, part, 4, backend="torch_sharded",
                           device="cpu", halo_exchange="ring")
