"""The port's GCN path against the JAX reference, in one process on the CPU:
the synthetic graph builder (bitwise), the GNN substrate, and ``forward``
on the reference's weights (carried over by ``repro_torch.convert``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.configs.base import GNN_SHAPES as R_GNN_SHAPES
from repro.configs.registry import get_config as r_get_config
from repro.data.graphs import build_csr as r_build_csr
from repro.data.graphs import random_graph_batch as r_random_graph_batch
from repro.models.gnn import api as r_api
from repro.models.gnn import common as r_common
from repro.models.gnn import gcn as r_gcn

from repro_torch.configs.base import GNN_SHAPES
from repro_torch.configs.registry import get_config
from repro_torch.convert import gcn_params_from_reference
from repro_torch.data.graphs import batch_to_device, build_csr, random_graph_batch
from repro_torch.kernels.segment_spmm.ops import (csr_from_packing, pack_edges,
                                                  packed_dst)
from repro_torch.models.gnn import api, common, gcn

SHAPES = {s.name: s for s in GNN_SHAPES}
R_SHAPES = {s.name: s for s in R_GNN_SHAPES}
CELLS = [("full_graph_sm", 1.0, 0), ("full_graph_sm", 1.0, 9),
         ("ogb_products", 1e-3, 0), ("ogb_products", 1e-3, 4)]


@pytest.mark.parametrize("cell,scale,seed", CELLS)
def test_random_graph_batch_bitwise(cell, scale, seed):
    cfg, ref = get_config("gcn-cora"), r_get_config("gcn-cora")
    ours = random_graph_batch(cfg, SHAPES[cell], seed=seed, scale=scale)
    theirs = r_random_graph_batch(ref, R_SHAPES[cell], seed=seed, scale=scale)
    assert set(ours) == set(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k]), k


def test_build_csr_bitwise():
    a, b = build_csr(500, 4000, seed=3), r_build_csr(500, 4000, seed=3)
    assert a.n == b.n and np.array_equal(a.row_ptr, b.row_ptr)
    assert np.array_equal(a.col, b.col)


@pytest.mark.parametrize("cell", ["full_graph_sm", "ogb_products", "molecule"])
def test_api_matches_reference(cell):
    cfg, ref = get_config("gcn-cora"), r_get_config("gcn-cora")
    shape, r_shape = SHAPES[cell], R_SHAPES[cell]
    assert api.feature_dim(cfg, shape) == r_api.feature_dim(ref, r_shape)
    assert api.is_graph_level(cfg, shape) == r_api.is_graph_level(ref, r_shape)
    assert api.n_graphs_of(shape) == r_api.n_graphs_of(r_shape)
    assert api.needs_positions(cfg) == r_api.needs_positions(ref)
    (s, dt), (rs, rdt) = api.target_spec(cfg, shape, 100), r_api.target_spec(ref, r_shape, 100)
    assert s == rs and np.dtype(dt) == np.dtype(rdt)


def test_unported_cells_and_kinds_raise():
    cfg = get_config("gcn-cora")
    with pytest.raises(ValueError, match="not ported"):
        random_graph_batch(cfg, SHAPES["molecule"], scale=0.1)
    with pytest.raises(ValueError, match="not ported"):
        api.init(dataclasses.replace(cfg, kind="gin"), SHAPES["full_graph_sm"],
                 device="cpu")


def test_scatter_sum_and_degrees_match_reference():
    rng = np.random.default_rng(2)
    n, e = 50, 400
    vals = rng.normal(size=(e, 3)).astype(np.float32)
    idx = rng.integers(0, n, e).astype(np.int32)
    mask = rng.random(e) < 0.7
    for m in (None, mask):
        want = np.asarray(r_common.scatter_sum(
            jnp.asarray(vals), jnp.asarray(idx), n,
            None if m is None else jnp.asarray(m)))
        got = common.scatter_sum(torch.from_numpy(vals), torch.from_numpy(idx), n,
                                 None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    deg = common.degrees(torch.from_numpy(idx), n, torch.from_numpy(mask))
    assert np.array_equal(deg.numpy(), np.asarray(
        r_common.degrees(jnp.asarray(idx), n, jnp.asarray(mask))))


def test_graph_csr_is_the_packing_order():
    batch = random_graph_batch(get_config("gcn-cora"), SHAPES["ogb_products"],
                               seed=1, scale=1e-3)
    n = batch["node_feat"].shape[0]
    csr = gcn.graph_csr(batch_to_device(batch, "cpu"))
    packed = pack_edges(batch["edge_src"], batch["edge_dst"], n)
    want = csr_from_packing(packed, packed_dst(packed), n)
    for name in ("row_ptr", "src", "order"):
        assert np.array_equal(getattr(csr, name).numpy(), getattr(want, name)), name


@pytest.mark.parametrize("cell,scale,seed,norm", [
    ("full_graph_sm", 1.0, 0, "sym"), ("ogb_products", 1e-3, 2, "sym"),
    ("ogb_products", 1e-3, 3, "mean"), ("full_graph_sm", 1.0, 5, "mean")])
def test_gcn_forward_matches_reference(cell, scale, seed, norm):
    cfg = dataclasses.replace(get_config("gcn-cora"), norm=norm)
    ref = dataclasses.replace(r_get_config("gcn-cora"), norm=norm)
    batch = random_graph_batch(cfg, SHAPES[cell], seed=seed, scale=scale)
    r_params, _ = r_api.init(jax.random.PRNGKey(seed), ref, R_SHAPES[cell])
    params = gcn_params_from_reference(jax.tree.map(np.asarray, r_params))
    want = np.asarray(r_gcn.forward(
        r_params, {k: jnp.asarray(v) for k, v in batch.items()}, ref))
    tensors = batch_to_device(batch, "cpu")
    got = gcn.forward(params, tensors, cfg)
    assert got.shape == (batch["node_feat"].shape[0], cfg.n_classes)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    # the cached CSR gives the same logits
    again = gcn.forward(params, tensors, cfg, csr=gcn.graph_csr(tensors))
    assert torch.equal(got, again)


def test_gcn_init_shapes_match_reference():
    cfg, ref = get_config("gcn-cora"), r_get_config("gcn-cora")
    shape = SHAPES["ogb_products"]
    r_params, _ = r_api.init(jax.random.PRNGKey(0), ref, R_SHAPES["ogb_products"])
    params = api.init(cfg, shape, seed=0, device="cpu")
    assert jax.tree.map(lambda a: a.shape, r_params) == \
        jax.tree.map(lambda t: tuple(t.shape), params)
