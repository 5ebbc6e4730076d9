"""Hypothesis twin of ``tests/test_property_sharded.py`` for the port.

* **random shard maps** — the one-rank sharded field under arbitrary
  vertex permutations equals the port's plain field bit for bit on both
  exchanges (and the reference's ``jnp`` field within its tolerance);
* **mutations against a permuted packing** — random ``MutationBatch``
  sequences patch the port's permuted packing to exactly the reference's
  patched packing, both source maps keep decoding to the true source of
  every slot, and the patched packing holds a scratch rebuild's edges;
* **k != S partition folding** — ``partition_shard_order`` is the
  reference's, a permutation keeping every partition contiguous.

Examples are few and each has a deadline, so the suite stays short."""
import numpy as np
import pytest

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import HealthCheck, given, settings, strategies as st

from repro.core.rpq import parse_rpq as r_parse
from repro.core.tpstry import TPSTry as RTPSTry
from repro.core.visitor import extroversion_field as r_field
from repro.graphs import generators as rgen
from repro.graphs import sharded_packing as rsp
from repro.graphs.graph import MutationBatch as RMutationBatch

from repro_torch.convert import from_reference_arrays
from repro_torch.core.rpq import parse_rpq
from repro_torch.core.tpstry import TPSTry
from repro_torch.core.visitor import extroversion_field
from repro_torch.graphs import sharded_packing as psp
from repro_torch.graphs.graph import MutationBatch

SET = settings(
    max_examples=6,
    deadline=30_000,
    suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large],
)

FIELDS = ("alpha", "pr", "edge_mass", "extro_mass", "extroversion", "ext_to")
QUERIES = ("L0.L1.(L2|L3).L1", "L1.L2.L0")


def _pair(n, seed, n_labels):
    rg = rgen.power_law_labelled(n, n_labels=n_labels, avg_degree=5.0, seed=seed)
    g = from_reference_arrays(graph=dict(
        n=rg.n, labels=rg.labels, label_names=rg.label_names, src=rg.src,
        dst=rg.dst)).graph
    return g, rg


def _order_for(kind, n, n_shards, rng):
    if kind == "identity":
        return None
    if kind == "random":
        return rng.permutation(n).astype(np.int64)
    part = rng.integers(0, rng.integers(2, 13), n)
    return rsp.partition_shard_order(part, n_shards)


def _decode_checks(sp, g):
    """Both source maps of every shard decode to the true global source."""
    raw = sp.slot_raw.reshape(-1)
    real = raw >= 0
    assert int(real.sum()) == g.m
    hot2pos = np.zeros(max(sp.n_hot, 1), np.int64)
    live_hot = sp.fr_hot_pos[: sp.n_frontier]
    hot2pos[live_hot[live_hot >= 0]] = sp.frontier[: sp.n_frontier][live_hot >= 0]
    rb = sp.round_base
    for s in range(sp.n_shards):
        r = sp.slot_raw[s] >= 0
        truth = sp.src_global[s][r]
        m_ = sp.src_map[s][r]
        own = m_ < sp.n_local_pad
        fidx = np.maximum(m_ - sp.n_local_pad, 0)
        dec = np.where(own, m_ + s * sp.n_local_pad, sp.frontier[fidx])
        assert np.array_equal(sp.vtx_at[dec], truth)
        msl = sp.src_map_sliced[s][r]
        rel = np.maximum(msl - sp.n_local_pad, 0)
        is_hot = rel < sp.hot_pad
        cold = np.maximum(rel - sp.hot_pad, 0)
        rnd = np.minimum(np.searchsorted(rb[1:], cold, side="right"),
                         sp.n_shards - 1)
        owner = (s - rnd) % sp.n_shards
        dec_cold = (sp.send_local[owner, s, np.minimum(cold - rb[rnd], sp.pair_cap - 1)]
                    + owner * sp.n_local_pad)
        dec_hot = hot2pos[np.minimum(rel, max(sp.n_hot - 1, 0))]
        dec_sl = np.where(own, dec, np.where(is_hot, dec_hot, dec_cold))
        assert np.array_equal(sp.vtx_at[dec_sl], truth)


@given(st.integers(80, 300), st.integers(0, 2**16),
       st.sampled_from(["identity", "random", "partition"]))
@SET
def test_sharded_field_bitwise_under_random_shard_maps(n, seed, kind):
    g, rg = _pair(n, seed, 5)
    rng = np.random.default_rng(seed + 1)
    arrays = TPSTry.from_workload(
        [(parse_rpq(QUERIES[0]), 0.6), (parse_rpq(QUERIES[1]), 0.4)]
    ).compile(g.label_names)
    r_arrays = RTPSTry.from_workload(
        [(r_parse(QUERIES[0]), 0.6), (r_parse(QUERIES[1]), 0.4)]
    ).compile(rg.label_names)
    k = int(rng.integers(2, 7))
    part = rng.integers(0, k, g.n).astype(np.int32)
    plain = extroversion_field(g, arrays, part, k, backend="torch", device="cpu")
    ref = r_field(rg, r_arrays, part, k, backend="jnp")
    order = _order_for(kind, g.n, 1, rng)
    for exchange in ("sliced", "psum"):
        pre = {} if order is None else {"_shard_order": (f"{kind}:0", order)}
        sh = extroversion_field(g, arrays, part, k, _precomputed=pre,
                                backend="torch_sharded", device="cpu",
                                halo_exchange=exchange)
        for f in FIELDS:
            assert np.array_equal(getattr(sh, f), getattr(plain, f)), f
            np.testing.assert_allclose(getattr(sh, f), getattr(ref, f), atol=2e-5,
                                       rtol=1e-4, err_msg=f"{kind}/{exchange}:{f}")


def _random_batch(g, rng, nv, na, nr, drop_vertex, nrl):
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
        remove_vertices=[int(rng.integers(0, g.n))] if drop_vertex else [],
        relabel=(np.stack([rng.integers(0, hi, nrl),
                           rng.integers(0, g.n_labels, nrl)], 1)
                 if nrl else np.zeros((0, 2), np.int64)))


@given(st.integers(60, 220), st.integers(0, 2**16), st.sampled_from([2, 4, 8]),
       st.sampled_from(["random", "partition"]),
       st.lists(st.tuples(st.integers(0, 3), st.integers(0, 10),
                          st.integers(0, 10), st.booleans(), st.integers(0, 2)),
                min_size=1, max_size=3))
@SET
def test_random_mutations_against_permuted_packing(n, seed, n_shards, kind, specs):
    g, rg = _pair(n, seed, 4)
    g.reverse_edge_index, rg.reverse_edge_index
    rng = np.random.default_rng(seed + 1)
    order = _order_for(kind, g.n, n_shards, rng)
    kw = dict(block_n=32, block_e=64, order=order, order_token=f"{kind}:0")
    g.vm_packing_sharded(n_shards, **kw)
    rg.vm_packing_sharded(n_shards, **kw)
    for spec in specs:
        batch = _random_batch(g, rng, *spec)
        g.apply_mutations(MutationBatch(**batch))
        rg.apply_mutations(RMutationBatch(**batch))
        sp = g.vm_packing_sharded(n_shards, **kw)
        ref = rg.vm_packing_sharded(n_shards, **kw)
        assert sp.version == g.version
        for name in ("meta", "src_map", "src_map_sliced", "src_global",
                     "dst_local", "dst_global", "dst_label", "inv_cnt",
                     "slot_raw", "vlabels", "frontier", "fr_local_idx",
                     "fr_owned", "pos_of", "vtx_at", "round_cap", "fr_slot",
                     "pair_cnt", "send_local", "shard_epoch"):
            assert np.array_equal(getattr(sp, name), getattr(ref, name)), name
        assert (sp.n_frontier, sp.fr_epoch) == (ref.n_frontier, ref.fr_epoch)
        _decode_checks(sp, g)
        scratch = psp.build_sharded_vm_packing(
            g, n_shards, g.cached_neighbor_label_counts(), block_n=32,
            block_e=64, order=sp.pos_of, order_token=f"{kind}:0")
        raw_a, raw_b = sp.slot_raw.reshape(-1), scratch.slot_raw.reshape(-1)
        ok_a, ok_b = raw_a >= 0, raw_b >= 0
        oa, ob = np.argsort(raw_a[ok_a]), np.argsort(raw_b[ok_b])
        for nm in ("src_global", "dst_global", "dst_label", "inv_cnt"):
            assert np.array_equal(getattr(sp, nm).reshape(-1)[ok_a][oa],
                                  getattr(scratch, nm).reshape(-1)[ok_b][ob]), nm
        assert np.array_equal(sp.vlabels, scratch.vlabels)


@given(st.integers(1, 16), st.integers(1, 12), st.integers(0, 2**16),
       st.integers(50, 400))
@SET
def test_partition_fold_properties(k, n_shards, seed, n):
    part = np.random.default_rng(seed).integers(0, k, n)
    pos = psp.partition_shard_order(part, n_shards)
    assert np.array_equal(pos, rsp.partition_shard_order(part, n_shards))
    assert np.array_equal(np.sort(pos), np.arange(n))
    for p in range(k):
        ps = np.sort(pos[part == p])
        if ps.size:
            assert ps[-1] - ps[0] == ps.size - 1
