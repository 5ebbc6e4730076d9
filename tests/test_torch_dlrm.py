"""The port's DLRM path against the JAX reference, in one process on the CPU:
configurations, the click-log pipeline (bitwise), ``serve_step`` and
``retrieval_step`` on the reference's weights (carried over by
``repro_torch.convert``), the co-access graph and query span (bitwise), and
the whole TAPER row-placement flow of ``benchmarks/dlrm_span.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.configs.base import DLRM_SHAPES as R_DLRM_SHAPES
from repro.configs.registry import get_config as r_get_config
from repro.core.rpq import concat as r_concat
from repro.core.rpq import label as r_label
from repro.core.taper import Taper as RTaper
from repro.core.taper import TaperConfig as RTaperConfig
from repro.data.recsys import ClickLogPipeline as RClickLogPipeline
from repro.graphs.partition import hash_partition as r_hash_partition
from repro.models import dlrm as r_dlrm

from repro_torch.configs.base import DLRM_SHAPES
from repro_torch.configs.registry import get_config, list_archs, shapes_for
from repro_torch.convert import dlrm_params_from_reference
from repro_torch.core.rpq import concat, label
from repro_torch.core.taper import Taper, TaperConfig
from repro_torch.data.recsys import ClickLogPipeline
from repro_torch.graphs.partition import hash_partition
from repro_torch.models import dlrm

#: dlrm_span's shard count and settings (benchmarks/dlrm_span.py)
K = 64


def _cfgs(multi_hot=1):
    return (dataclasses.replace(get_config("dlrm-rm2").reduced(), multi_hot=multi_hot),
            dataclasses.replace(r_get_config("dlrm-rm2").reduced(), multi_hot=multi_hot))


@pytest.mark.parametrize("arch", ["dlrm-rm2", "gcn-cora"])
def test_configs_equal_the_reference(arch):
    cfg, ref = get_config(arch), r_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(ref.reduced())
    assert [(s.name, s.kind, s.dims) for s in shapes_for(arch)] == \
        [(s.name, s.kind, s.dims) for s in ref.shapes]
    assert arch in list_archs()


def test_dlrm_rm2_sizes():
    cfg = get_config("dlrm-rm2")
    assert cfg.total_rows() == 33_762_577
    assert cfg.n_params() == r_get_config("dlrm-rm2").n_params()
    assert cfg.total_rows() * cfg.embed_dim > 2**31       # 64-bit row offsets
    assert [(s.name, s.dims) for s in DLRM_SHAPES] == \
        [(s.name, s.dims) for s in R_DLRM_SHAPES]


@pytest.mark.parametrize("multi_hot,seed,batch", [(1, 0, 64), (4, 3, 33), (8, 7, 128)])
def test_click_log_pipeline_bitwise(multi_hot, seed, batch):
    cfg, ref = _cfgs(multi_hot)
    ours, theirs = ClickLogPipeline(cfg, batch, seed=seed), RClickLogPipeline(ref, batch, seed=seed)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def _weights(ref_cfg, seed=0):
    r_params, _ = r_dlrm.init(jax.random.PRNGKey(seed), ref_cfg)
    return r_params, dlrm_params_from_reference(jax.tree.map(np.asarray, r_params),
                                                    device="cpu")


def test_dlrm_params_from_reference_defaults_to_the_card(monkeypatch):
    r_params, _ = r_dlrm.init(jax.random.PRNGKey(0), _cfgs()[1])
    tree = jax.tree.map(np.asarray, r_params)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dlrm_params_from_reference(tree)


@pytest.mark.parametrize("multi_hot", [1, 4])
def test_serve_step_matches_reference(multi_hot):
    cfg, ref = _cfgs(multi_hot)
    r_params, params = _weights(ref)
    batch = next(ClickLogPipeline(cfg, 96, seed=11))
    want = np.asarray(r_dlrm.serve_step(
        r_params, {k: jnp.asarray(v) for k, v in batch.items()}, ref))
    got = dlrm.serve_step(params, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert got.shape == (96,) and bool(((got >= 0) & (got <= 1)).all())


def test_retrieval_step_matches_reference():
    cfg, ref = _cfgs()
    r_params, params = _weights(ref, seed=2)
    rng = np.random.default_rng(4)
    cand = rng.normal(size=(20000, cfg.embed_dim)).astype(np.float32)
    dense = rng.normal(size=(1, cfg.n_dense)).astype(np.float32)
    r_vals, r_idx = r_dlrm.retrieval_step(r_params, {"dense": jnp.asarray(dense)},
                                          jnp.asarray(cand), top_k=100)
    vals, idx = dlrm.retrieval_step(params, {"dense": torch.from_numpy(dense)},
                                    torch.from_numpy(cand), top_k=100)
    np.testing.assert_allclose(vals.numpy(), np.asarray(r_vals), rtol=1e-5, atol=1e-6)
    # tie order may differ between jax.lax.top_k and torch.topk: compare sets
    assert set(idx.tolist()) == set(np.asarray(r_idx).tolist())


def test_init_shapes_match_reference():
    cfg, ref = _cfgs()
    r_params, _ = r_dlrm.init(jax.random.PRNGKey(0), ref)
    params = dlrm.init(cfg, seed=0, device="cpu")
    assert jax.tree.map(lambda a: a.shape, r_params) == \
        jax.tree.map(lambda t: tuple(t.shape), params)
    assert np.array_equal(dlrm.table_offsets(cfg), r_dlrm.table_offsets(ref))
    again = dlrm.init(cfg, seed=0, device="cpu")
    assert torch.equal(params["embedding"], again["embedding"])   # seeded


def test_coaccess_graph_and_query_span_bitwise():
    cfg, ref = _cfgs()
    pipe = ClickLogPipeline(cfg, 256, seed=5)
    batches = [next(pipe)["sparse"] for _ in range(3)]
    g, inv = dlrm.coaccess_graph(cfg, batches, max_rows_per_field=50)
    rg, rinv = r_dlrm.coaccess_graph(ref, batches, max_rows_per_field=50)
    assert g.n == rg.n and np.array_equal(inv, rinv)
    for name in ("labels", "src", "dst", "row_ptr"):
        assert np.array_equal(getattr(g, name), getattr(rg, name)), name
    assert g.label_names == rg.label_names
    place = hash_partition(cfg.total_rows(), 16, seed=3)
    for b in batches:
        assert dlrm.query_span(place, b, 16) == r_dlrm.query_span(place, b, 16)


def _span_flow(get, pipeline, coaccess, conc, lab, hashp, taper, taper_config,
               span, extra_config, extra_taper):
    """benchmarks/dlrm_span.py's flow, for either package."""
    base = get("dlrm-rm2")
    cfg = dataclasses.replace(base.reduced(), vocab_sizes=tuple(
        min(v, 1000) for v in base.vocab_sizes))
    pipe = pipeline(cfg, batch=1024, seed=0, n_segments=32, p_segment=0.95)
    batches = [next(pipe)["sparse"] for _ in range(4)]
    g, row_of_vertex = coaccess(cfg, batches, max_rows_per_field=1000)
    w = [(conc(lab(f"F{i}"), lab(f"F{j}")), 1.0)
         for i in range(cfg.n_sparse) for j in range(cfg.n_sparse) if i != j]
    w = [(q, 1.0 / len(w)) for q, _ in w]
    part0 = hashp(g.n, K, seed=1)
    rep = taper(g, K, taper_config(max_iterations=5, balance_eps=0.2,
                                   family_max_size=26, seed=0, **extra_config),
                **extra_taper).invoke(part0, w)
    place0 = hashp(cfg.total_rows(), K, seed=1)
    place1 = place0.copy()
    place1[row_of_vertex] = rep.final_part
    evals = [next(pipe)["sparse"] for _ in range(4)]
    return (g, rep, np.mean([span(place0, b, K) for b in evals]),
            np.mean([span(place1, b, K) for b in evals]))


def test_dlrm_span_flow_matches_reference():
    """The row placement end to end: the port on the CPU against the
    reference's jnp field, in one process (trie numbering follows the
    string-hash seed).  Partitions and both spans are equal."""
    rg, rrep, rspan0, rspan1 = _span_flow(
        r_get_config, RClickLogPipeline, r_dlrm.coaccess_graph, r_concat, r_label,
        r_hash_partition, RTaper, RTaperConfig, r_dlrm.query_span,
        {"field_backend": "jnp"}, {})
    g, rep, span0, span1 = _span_flow(
        get_config, ClickLogPipeline, dlrm.coaccess_graph, concat, label,
        hash_partition, Taper, TaperConfig, dlrm.query_span, {}, {"device": "cpu"})
    assert np.array_equal(g.src, rg.src) and np.array_equal(g.dst, rg.dst)
    assert rep.iterations == rrep.iterations
    assert len(rep.parts) == len(rrep.parts)
    for a, b in zip(rep.parts, rrep.parts):
        assert np.array_equal(a, b)
    assert (span0, span1) == (rspan0, rspan1)
    assert span1 < span0
