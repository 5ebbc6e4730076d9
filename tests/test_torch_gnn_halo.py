"""The port's partition-aware distributed GCN (``models/gnn/distributed.py``)
against the JAX package's, in one process on the CPU.

``HaloPlan`` and ``halo_bytes_per_step`` bitwise the reference's on
musicbrainz N=2000 (k=8) under hash, metis-like and random partitions;
``partitioned_gcn_forward`` (a ``segment_spmm`` call a partition, the
partial sums added in partition order) within 1e-5 of the reference's and
of the port's monolithic ``gcn.forward``, with the same halo bytes; and
``benchmarks/gnn_halo.py``'s four byte counts (hash, metis, hash + TAPER,
metis + TAPER; TAPER on the port's ``torch`` field, ``max_iterations=6``,
the benchmark's 2-label workload) equal to the reference's and to
``BENCH_PR10.json``'s, written here as literals."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.configs.registry import get_config as r_get_config
from repro.core.rpq import parse_rpq as r_parse_rpq
from repro.core.taper import Taper as RTaper
from repro.core.taper import TaperConfig as RTaperConfig
from repro.graphs.generators import musicbrainz_like as r_musicbrainz_like
from repro.graphs.partition import hash_partition as r_hash_partition
from repro.graphs.partition import metis_like_partition as r_metis_like_partition
from repro.models.gnn import distributed as r_dist
from repro.models.gnn import gcn as r_gcn

from repro_torch.configs.registry import get_config
from repro_torch.convert import gcn_params_from_reference
from repro_torch.core.rpq import parse_rpq
from repro_torch.core.taper import Taper, TaperConfig
from repro_torch.graphs.generators import musicbrainz_like
from repro_torch.graphs.partition import hash_partition, metis_like_partition
from repro_torch.kernels.segment_spmm.ops import segment_spmm_csr
from repro_torch.models.gnn import gcn
from repro_torch.models.gnn.distributed import (HaloPlan, halo_bytes_per_step,
                                                partitioned_gcn_forward)

K, N, D_FEAT = 8, 2000, 64
#: BENCH_PR10.json, gnn_halo/{hash, metis, hash+taper, metis+taper}:
#: halo_bytes_per_fwd at musicbrainz N=2000
BENCH_PR10_BYTES = {"hash": 1607040, "metis": 587520,
                    "hash+taper": 915200, "metis+taper": 582400}


@pytest.fixture(scope="module")
def graphs():
    return (musicbrainz_like(N, avg_degree=6.0, seed=13),
            r_musicbrainz_like(N, avg_degree=6.0, seed=13))


def _workload(g, parse):
    """``benchmarks/gnn_halo.py::gnn_workload``: every 2-label path,
    weighted by the first label's frequency."""
    names = g.label_names
    freqs = g.label_counts() / g.n
    out = []
    for i, a in enumerate(names):
        for b in names:
            w = float(freqs[i])
            if w > 0:
                out.append((parse(f"{a}.{b}"), w))
    total = sum(f for _, f in out)
    return [(q, f / total) for q, f in out]


def _parts(g):
    return {"hash": hash_partition(g.n, K, seed=1),
            "metis": metis_like_partition(g, K, seed=0),
            "random": np.random.default_rng(4).integers(0, K, g.n).astype(np.int32)}


def test_halo_plan_bitwise(graphs):
    g, rg = graphs
    for name, part in _parts(g).items():
        for d in (16, 64):
            ours, theirs = HaloPlan.build(g, part, d, K), r_dist.HaloPlan.build(rg, part, d, K)
            assert (ours.k, ours.total_halo_rows, ours.bytes_per_layer) == \
                (theirs.k, theirs.total_halo_rows, theirs.bytes_per_layer), name
            assert all(a.dtype == b.dtype and np.array_equal(a, b)
                       for a, b in zip(ours.halo_rows, theirs.halo_rows)), name
        for arch in ("gcn-cora", "gin-tu"):
            assert halo_bytes_per_step(g, part, get_config(arch), D_FEAT, K) == \
                r_dist.halo_bytes_per_step(rg, part, r_get_config(arch), D_FEAT, K)


@pytest.mark.parametrize("part_name", ["hash", "metis"])
def test_partitioned_gcn_forward(graphs, part_name):
    g, rg = graphs
    part = _parts(g)[part_name]
    cfg, ref = get_config("gcn-cora"), r_get_config("gcn-cora")
    r_params, _ = r_gcn.init(jax.random.PRNGKey(2), ref, D_FEAT)
    params = gcn_params_from_reference(jax.tree.map(np.asarray, r_params), device="cpu")
    x = np.random.default_rng(5).normal(size=(N, D_FEAT)).astype(np.float32)
    want, want_bytes = r_dist.partitioned_gcn_forward(r_params, rg, part, x, ref, K)
    launches = segment_spmm_csr.launches
    got, got_bytes = partitioned_gcn_forward(params, g, part, x, cfg, K)
    assert segment_spmm_csr.launches == launches          # CPU calls count none
    assert got_bytes == want_bytes
    assert got.shape == (N, cfg.n_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # the monolithic forward over the same graph
    E = g.src.shape[0]
    batch = {"node_feat": torch.as_tensor(x), "edge_src": torch.as_tensor(g.src),
             "edge_dst": torch.as_tensor(g.dst), "node_mask": torch.ones(N, dtype=torch.bool),
             "edge_mask": torch.ones(E, dtype=torch.bool)}
    mono = gcn.forward(params, batch, cfg)
    np.testing.assert_allclose(got.numpy(), mono.numpy(), rtol=1e-5, atol=1e-5)
    mono_ref = r_gcn.forward(r_params, {k: jnp.asarray(v.numpy()) for k, v in batch.items()},
                             ref)
    np.testing.assert_allclose(np.asarray(want), np.asarray(mono_ref), rtol=1e-5, atol=1e-5)


def test_gnn_halo_bytes_match_reference_and_bench(graphs):
    """``benchmarks/gnn_halo.py``'s setting through both packages."""
    g, rg = graphs
    cfg, ref = get_config("gcn-cora"), r_get_config("gcn-cora")
    parts = _parts(g)
    taper = Taper(g, K, TaperConfig(max_iterations=6, seed=0), device="cpu")
    w = _workload(g, parse_rpq)
    parts["hash+taper"] = taper.invoke(parts["hash"], w).final_part
    parts["metis+taper"] = taper.invoke(parts["metis"], w).final_part

    r_hash, r_metis = r_hash_partition(rg.n, K, seed=1), r_metis_like_partition(rg, K, seed=0)
    r_taper = RTaper(rg, K, RTaperConfig(max_iterations=6, seed=0))
    r_w = _workload(rg, r_parse_rpq)
    r_parts = {"hash": r_hash, "metis": r_metis,
               "hash+taper": r_taper.invoke(r_hash, r_w).final_part,
               "metis+taper": r_taper.invoke(r_metis, r_w).final_part}
    for name, want in BENCH_PR10_BYTES.items():
        assert np.array_equal(parts[name], r_parts[name]), name
        ours = halo_bytes_per_step(g, parts[name], cfg, D_FEAT, K)
        assert ours == r_dist.halo_bytes_per_step(rg, r_parts[name], ref, D_FEAT, K) == want, name
