"""Port parity (bitwise) of the host-side graph layer: graph arrays,
generators, partitioners, metrics and the edge packings, against the JAX
reference package on the same inputs, in one process."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.graphs import generators as rgen
from repro.graphs import metrics as rmetrics
from repro.graphs import partition as rpart
from repro.graphs.graph import LabelledGraph as RGraph
from repro.kernels.segment_spmm.ops import pack_edges as r_pack_edges
from repro.kernels.segment_spmm.ops import pack_weights as r_pack_weights
from repro.kernels.vm_step.ops import pack_vm_inputs as r_pack_vm_inputs

from repro_torch.graphs import generators as pgen
from repro_torch.graphs import metrics as pmetrics
from repro_torch.graphs import partition as ppart
from repro_torch.graphs.graph import LabelledGraph as PGraph
from repro_torch.kernels.segment_spmm.ops import pack_edges, pack_weights
from repro_torch.kernels.vm_step.ops import pack_vm_inputs

BLOCKS = [(8, 8), (64, 128), (128, 256)]


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _same_graph(pg, rg):
    assert pg.n == rg.n and pg.label_names == rg.label_names
    for f in ("labels", "src", "dst", "row_ptr"):
        assert _eq(getattr(pg, f), getattr(rg, f)), f


def _random_edges(seed, n, e, hub_frac=0.0):
    rng = np.random.default_rng(seed)
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], axis=1)
    if hub_frac:
        edges[: int(e * hub_frac), 0] = 7          # hub vertex 7
    labels = rng.integers(0, 4, n)
    return labels, edges


@pytest.mark.parametrize("seed,n,e,hub", [(0, 50, 120, 0.0), (1, 300, 900, 0.3),
                                           (2, 1000, 400, 0.5)])
def test_graph_arrays_bitwise(seed, n, e, hub):
    labels, edges = _random_edges(seed, n, e, hub)
    pg = PGraph.from_undirected_edges(n, labels, edges)
    rg = RGraph.from_undirected_edges(n, labels, edges)
    _same_graph(pg, rg)
    assert _eq(pg.reverse_edge_index, rg.reverse_edge_index)
    assert _eq(pg.neighbor_label_counts(), rg.neighbor_label_counts())
    assert _eq(pg.label_counts(), rg.label_counts())
    assert _eq(pg.degrees, rg.degrees)
    vs = np.array([3, 7, 0, 7])
    assert _eq(pg.edge_indices_of(vs), rg.edge_indices_of(vs))


@pytest.mark.parametrize("name,n,seed", [("provgen_like", 1500, 11),
                                         ("musicbrainz_like", 1500, 13),
                                         ("provgen_like", 700, 3)])
def test_generators_bitwise(name, n, seed):
    _same_graph(getattr(pgen, name)(n, seed=seed), getattr(rgen, name)(n, seed=seed))


def test_paper_graph_bitwise():
    _same_graph(pgen.paper_example_graph(), rgen.paper_example_graph())
    assert _eq(pgen.paper_example_partition(), rgen.paper_example_partition())


@pytest.mark.parametrize("n,k,seed", [(10, 2, 0), (2000, 8, 1), (12345, 7, 5)])
def test_hash_partition_bitwise(n, k, seed):
    assert _eq(ppart.hash_partition(n, k, seed=seed),
               rpart.hash_partition(n, k, seed=seed))


@pytest.mark.parametrize("k,seed", [(4, 0), (8, 2)])
def test_metis_like_partition_and_metrics_bitwise(k, seed):
    pg = pgen.provgen_like(900, seed=4)
    rg = rgen.provgen_like(900, seed=4)
    p = ppart.metis_like_partition(pg, k, seed=seed)
    r = rpart.metis_like_partition(rg, k, seed=seed)
    assert _eq(p, r)
    assert pmetrics.edge_cut(pg, p) == rmetrics.edge_cut(rg, r)
    assert pmetrics.edge_cut(pg, p, directed=True) == rmetrics.edge_cut(rg, r, directed=True)
    assert pmetrics.partition_balance(p, k) == rmetrics.partition_balance(r, k)
    assert _eq(pmetrics.partition_sizes(p, k), rmetrics.partition_sizes(r, k))


def _packing_graph(seed):
    """Graph with a hub vertex and whole destination blocks left empty
    (vertices 64..191 have no edges)."""
    rng = np.random.default_rng(seed)
    n = 300
    pool = np.concatenate([np.arange(0, 64), np.arange(192, n)])
    e = 700
    edges = np.stack([rng.choice(pool, e), rng.choice(pool, e)], axis=1)
    edges[:250, 0] = 5                               # hub
    return n, rng.integers(0, 3, n), edges


@pytest.mark.parametrize("block_n,block_e", BLOCKS)
def test_pack_edges_and_weights_bitwise(block_n, block_e):
    n, labels, edges = _packing_graph(block_n)
    g = PGraph.from_undirected_edges(n, labels, edges)
    p = pack_edges(g.src, g.dst, n, block_n, block_e)
    r = r_pack_edges(g.src, g.dst, n, block_n, block_e)
    for f in ("src", "dst_local", "meta", "pad_mask", "order"):
        assert _eq(getattr(p, f), getattr(r, f)), f
    assert (p.n_blocks_out, p.block_n, p.block_e) == (r.n_blocks_out, r.block_n, r.block_e)
    w = np.random.default_rng(0).random(g.m).astype(np.float32)
    assert _eq(pack_weights(p, w), r_pack_weights(r, w))


@pytest.mark.parametrize("block_n,block_e", BLOCKS)
def test_pack_vm_inputs_and_vm_packing_bitwise(block_n, block_e):
    n, labels, edges = _packing_graph(block_e)
    pg = PGraph.from_undirected_edges(n, labels, edges, ["a", "b", "c"])
    rg = RGraph.from_undirected_edges(n, labels, edges, ["a", "b", "c"])
    cnt = pg.neighbor_label_counts()
    p, p_lab, p_inv = pack_vm_inputs(pg.src, pg.dst, pg.labels, cnt, n, block_n, block_e)
    r, r_lab, r_inv = r_pack_vm_inputs(rg.src, rg.dst, rg.labels, cnt, n, block_n, block_e)
    assert _eq(p.src, r.src) and _eq(p_lab, r_lab) and _eq(p_inv, r_inv)
    pe = pg.vm_packing(block_n=block_n, block_e=block_e)
    re = rg.vm_packing(block_n=block_n, block_e=block_e)
    for f in ("src", "dst_local", "meta", "pad_mask", "order"):
        assert _eq(getattr(pe[0], f), getattr(re[0], f)), f
    for a, b in zip(pe[1:], re[1:]):               # dst_label, inv_cnt, dst_global
        assert _eq(a, b)


def test_vm_csr_is_the_stable_dst_sort():
    n, labels, edges = _packing_graph(1)
    g = PGraph.from_undirected_edges(n, labels, edges)
    csr = g.vm_csr()
    assert _eq(csr.order, np.argsort(g.dst, kind="stable"))
    assert _eq(csr.src, g.src[csr.order])
    deg = np.bincount(g.dst, minlength=n)
    assert _eq(csr.row_ptr, np.concatenate([[0], np.cumsum(deg)]).astype(np.int32))
    # within each destination row, sources ascend (the reference scatter order)
    rows = np.repeat(np.arange(n), deg)
    key = rows.astype(np.int64) * n + csr.src
    assert (np.diff(key) > 0).all()
