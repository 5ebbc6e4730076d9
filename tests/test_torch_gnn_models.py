"""The port's GIN, NequIP and EquiformerV2 (``repro_torch/models/gnn``)
against the JAX package's, in one process on the CPU.

Twins of ``tests/test_gnn_models.py``'s seven cases on the port's models
(energy invariance under rotation + translation at the reference suite's
2e-4, energy changing with geometry, GCN permutation equivariance, the
sampler's shapes, validity and fanout); then, at ``reduced()`` with the
reference's weights carried over by ``repro_torch.convert``: each model's
forward within 1e-5 (GIN) and 1e-4 (the equivariant models) of the
reference's, and the loss and every gradient leaf through ``api.loss_fn``
within 1e-4 of the leaf's largest value of ``jax.value_and_grad``'s (for
the two leaves named at GRAD_FLOOR, that value at least 1e-2 of the tree's
largest gradient), and three AdamW steps' losses within 1e-4 of the
reference's; the
``molecule`` and ``minibatch_lg`` batches and the sampler's subgraph
bitwise the reference's; ``scatter_sum`` over the edge-id CSR (the card's
path, run here by its plain version) bitwise the plain scatter; and the
substrate's ``segment_softmax``, ``bessel_rbf`` and ``layer_norm``."""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.configs.base import GNN_SHAPES as R_GNN_SHAPES
from repro.configs.registry import get_config as r_get_config
from repro.data import graphs as r_graphs
from repro.models.gnn import api as r_api
from repro.models.gnn import common as r_common
from repro.models.gnn import equiformer as r_equiformer
from repro.models.gnn import gin as r_gin
from repro.models.gnn import nequip as r_nequip

from repro_torch import convert
from repro_torch.configs.base import GNN_SHAPES
from repro_torch.configs.registry import get_config, shapes_for
from repro_torch.data import graphs
from repro_torch.data.graphs import (NeighborSampler, batch_to_device, build_csr,
                                     random_graph_batch)
from repro_torch.models.gnn import api, common, equiformer, gcn, gin, nequip
from repro_torch.utils import tree

SHAPES = {s.name: s for s in GNN_SHAPES}
R_SHAPES = {s.name: s for s in R_GNN_SHAPES}
RNG = np.random.default_rng(3)
CONVERT = {"gin": convert.gin_params_from_reference,
           "nequip": convert.nequip_params_from_reference,
           "equiformer_v2": convert.equiformer_params_from_reference,
           "gcn": convert.gcn_params_from_reference}
#: forward against the reference: GIN (sums of a few terms), the
#: equivariant models (CG and Wigner products summed in other orders)
FWD_TOL = {"gin": 1e-5, "nequip": 1e-4, "equiformer_v2": 1e-4}
#: every gradient leaf within GRAD_TOL of its largest value
GRAD_TOL = 1e-4
#: but for two kinds of leaf, each a sum that cancels far below the tree's
#: scale, so only float32 rounding of its terms is left; for these the
#: largest value is taken at least GRAD_FLOOR of the tree's largest
#: gradient.  GIN's eps, one scalar over every node and feature (layer 0's
#: on minibatch_lg: 1.7e-8 off on 1.5e-4, 1.1e-4 of it, the tree's largest
#: 1.1); Equiformer's attention-logit bias, exactly 0 as a softmax is
#: shift invariant (|g| 1.5e-8 to 8.9e-8, 3.7e-8 to 7.5e-8 off, the tree's
#: largest 188).  Leaves matched by path, ``[...]/['eps']`` and
#: ``['attn']/[1]/['b']``
GRAD_FLOOR = 1e-2
FLOORED_LEAVES = {"gin": r"\['eps'\]$", "equiformer_v2": r"\['attn'\]/\[1\]/\['b'\]$"}


def _mol_batch(n_nodes=12, n_edges=40, seed=0):
    rng = np.random.default_rng(seed)
    d = api.N_SPECIES
    feat = np.zeros((n_nodes, d), np.float32)
    feat[np.arange(n_nodes), rng.integers(0, d, n_nodes)] = 1.0
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    pos = rng.normal(size=(n_nodes, 3)).astype(np.float32)
    return {
        "node_feat": torch.as_tensor(feat),
        "edge_src": torch.as_tensor(src),
        "edge_dst": torch.as_tensor(dst),
        "node_mask": torch.ones(n_nodes, dtype=torch.bool),
        "edge_mask": torch.as_tensor(src != dst),
        "positions": torch.as_tensor(pos),
        "graph_id": torch.zeros(n_nodes, dtype=torch.int32),
        "targets": torch.zeros((1,), dtype=torch.float32),
    }


def _random_rot():
    a = RNG.uniform(-np.pi, np.pi)
    b = RNG.uniform(0, np.pi)
    g = RNG.uniform(-np.pi, np.pi)
    ca, sa, cb, sb, cg, sg = np.cos(a), np.sin(a), np.cos(b), np.sin(b), np.cos(g), np.sin(g)
    Rz1 = np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]])
    Ry = np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]])
    Rz2 = np.array([[cg, -sg, 0], [sg, cg, 0], [0, 0, 1]])
    return (Rz1 @ Ry @ Rz2).astype(np.float32)


# --- twins of tests/test_gnn_models.py -------------------------------------

@pytest.mark.parametrize("model,arch", [(nequip, "nequip"), (equiformer, "equiformer-v2")])
def test_energy_invariance_under_rotation_translation(model, arch):
    """Predicted energies are invariant to a global rotation + translation."""
    cfg = get_config(arch).reduced()
    batch = _mol_batch()
    params = model.init(cfg, api.N_SPECIES, seed=0, device="cpu")
    e0 = model.forward(params, batch, cfg, 1)
    R = torch.as_tensor(_random_rot())
    t = torch.as_tensor(RNG.normal(size=(1, 3)).astype(np.float32))
    batch_rot = dict(batch, positions=batch["positions"] @ R.T + t)
    e1 = model.forward(params, batch_rot, cfg, 1)
    np.testing.assert_allclose(e0.detach().numpy(), e1.detach().numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("model,arch", [(nequip, "nequip"), (equiformer, "equiformer-v2")])
def test_energy_changes_with_geometry(model, arch):
    """Sanity: the model is not constant — perturbing geometry changes E."""
    cfg = get_config(arch).reduced()
    batch = _mol_batch()
    params = model.init(cfg, api.N_SPECIES, seed=0, device="cpu")
    e0 = model.forward(params, batch, cfg, 1)
    e1 = model.forward(params, dict(batch, positions=batch["positions"] * 1.3), cfg, 1)
    assert abs(float(e0[0]) - float(e1[0])) > 1e-6


def test_gcn_permutation_equivariance():
    cfg = get_config("gcn-cora").reduced()
    shape = shapes_for("gcn-cora")[0]
    b = random_graph_batch(cfg, shape, seed=1, scale=0.05)
    batch = batch_to_device(b, "cpu")
    params = gcn.init(cfg, b["node_feat"].shape[1], seed=0, device="cpu")
    out = gcn.forward(params, batch, cfg)
    n = b["node_feat"].shape[0]
    perm = torch.as_tensor(RNG.permutation(n))
    inv = torch.argsort(perm)
    pb = dict(batch, node_feat=batch["node_feat"][perm], node_mask=batch["node_mask"][perm],
              edge_src=inv[batch["edge_src"].long()], edge_dst=inv[batch["edge_dst"].long()])
    out_p = gcn.forward(params, pb, cfg)
    np.testing.assert_allclose(out_p.numpy(), out[perm].numpy(), rtol=1e-4, atol=1e-5)


def test_neighbor_sampler_shapes_and_validity():
    g = build_csr(5000, 80000, seed=0)
    sampler = NeighborSampler(g, (15, 10))
    rng = np.random.default_rng(0)
    seeds = rng.integers(0, g.n, 64)
    sub = sampler.sample(seeds, rng)
    assert len(sub.nodes) == sampler.max_nodes(64) == 64 * (1 + 15 + 15 * 10)
    assert sub.edge_src.shape == sub.edge_dst.shape
    # all masked edges reference valid local nodes
    n_valid = int(sub.node_mask.sum())
    assert sub.edge_src[sub.edge_mask].max() < n_valid
    assert sub.edge_dst[sub.edge_mask].max() < n_valid
    # every sampled edge exists in the base graph
    for s, d in zip(sub.edge_src[sub.edge_mask][:100], sub.edge_dst[sub.edge_mask][:100]):
        u, w = sub.nodes[s], sub.nodes[d]
        assert u in g.col[g.row_ptr[w]: g.row_ptr[w + 1]]


def test_sampler_respects_fanout_distribution():
    g = build_csr(2000, 60000, seed=1)
    sub = NeighborSampler(g, (5,)).sample(np.arange(32), np.random.default_rng(1))
    # seeds with degree > 0 contribute exactly fanout edges
    deg = g.row_ptr[1:] - g.row_ptr[:-1]
    assert int(sub.edge_mask.sum()) == sum(5 for s in range(32) if deg[s] > 0)


# --- the data pipeline, bitwise ----------------------------------------------

@pytest.mark.parametrize("arch", ["gin-tu", "nequip", "equiformer-v2", "gcn-cora"])
@pytest.mark.parametrize("cell,scale,seed", [("molecule", 1.0, 0), ("molecule", 0.05, 7),
                                             ("minibatch_lg", 0.01, 0)])
def test_batches_bitwise(arch, cell, scale, seed):
    ours = random_graph_batch(get_config(arch), SHAPES[cell], seed=seed, scale=scale)
    theirs = r_graphs.random_graph_batch(r_get_config(arch), R_SHAPES[cell], seed=seed,
                                         scale=scale)
    assert set(ours) == set(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k]), k


@pytest.mark.parametrize("fanouts,n_seeds", [((15, 10), 64), ((5,), 32), ((3, 2, 2), 17)])
def test_sampler_subgraph_bitwise(fanouts, n_seeds):
    g, rg = build_csr(3000, 40000, seed=2, skew=1.5), r_graphs.build_csr(3000, 40000, seed=2,
                                                                         skew=1.5)
    seeds = np.random.default_rng(5).integers(0, 3000, n_seeds)
    ours = NeighborSampler(g, fanouts).sample(seeds, np.random.default_rng(9))
    theirs = r_graphs.NeighborSampler(rg, fanouts).sample(seeds, np.random.default_rng(9))
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    cfg = get_config("gin-tu")
    rng_a, rng_b = np.random.default_rng(4), np.random.default_rng(4)
    a = graphs.subgraph_to_batch(ours, cfg, SHAPES["minibatch_lg"], 602, rng_a)
    b = r_graphs.subgraph_to_batch(theirs, r_get_config("gin-tu"), R_SHAPES["minibatch_lg"],
                                   602, rng_b)
    assert set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


# --- the substrate -----------------------------------------------------------

@pytest.mark.parametrize("tail", [(), (3,), (4, 9)])
@pytest.mark.parametrize("masked", [False, True])
def test_scatter_sum_csr_is_the_plain_scatter_bitwise(tail, masked):
    """The card's path (one ``segment_spmm_csr`` over the edge-id CSR, run
    here by the kernel's plain version) against the plain scatter; masked
    edges hold NaN and stay out of both."""
    rng = np.random.default_rng(len(tail) + 10 * masked)
    n, e = 300, 4000
    idx = rng.integers(0, n // 2, e)
    idx[:700] = 5                              # a hub row
    vals = torch.as_tensor(rng.normal(size=(e,) + tail), dtype=torch.float32)
    mask = torch.as_tensor(rng.random(e) < 0.8) if masked else None
    if masked:
        vals[~mask] = float("nan")
    index = torch.as_tensor(idx)
    want = common.scatter_sum_plain(vals, index, n, mask)
    got = common.scatter_sum_csr(vals, index, n, mask)
    assert got.shape == (n,) + tail and torch.equal(got, want)
    assert torch.equal(common.scatter_sum(vals, index, n, mask), want)
    assert not torch.isnan(got).any()
    plan = common.sum_plan(index, n, mask)     # built once, used again
    assert torch.equal(common.scatter_sum_csr(vals, index, n, mask, plan), want)
    with pytest.raises(ValueError, match="plan"):
        common.scatter_sum_csr(vals[1:], index[1:], n, None, plan)


@pytest.mark.parametrize("arch", ["gin-tu", "nequip", "equiformer-v2"])
def test_sums_over_the_batch_plan_are_the_plain_sums_bitwise(arch, monkeypatch):
    """The card's path on the molecule cell: every ``scatter_sum`` (the
    message sums, Equiformer's softmax denominators, the pooled readouts)
    sent through ``scatter_sum_csr`` over the plans of ``api.batch_plan``
    or, for GIN's readout, one ``sum_plan`` a forward (the kernel's plain
    version here); the loss and every gradient leaf bitwise those of the
    plain scatter.  The denominator's plan skips the masked edges that the
    plain sum adds as 0."""
    cfg = get_config(arch).reduced()
    shape = SHAPES["molecule"]
    batch = batch_to_device(random_graph_batch(cfg, shape, seed=2, scale=0.05), "cpu")
    params = api.init(cfg, shape, seed=0, device="cpu")

    def loss_and_grads(csr):
        (loss, _), grads = tree.value_and_grad(
            lambda p: api.loss_fn(p, batch, cfg, shape, csr), params)
        return [loss] + tree.leaves(grads)

    want = loss_and_grads(None)
    calls = []

    def through_csr(values, index, n, mask=None, plan=None):
        calls.append(plan is not None)
        return common.scatter_sum_csr(values, index, n, mask, plan)

    for module in (common, gin, nequip, equiformer):
        monkeypatch.setattr(module, "scatter_sum", through_csr)
    got = loss_and_grads(api.batch_plan(cfg, batch, shape))
    assert calls and all(calls)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_substrate_matches_reference():
    rng = np.random.default_rng(6)
    n, e = 40, 300
    logits = rng.normal(size=(e, 3)).astype(np.float32)
    idx = rng.integers(0, n - 5, e).astype(np.int32)     # rows n-5.. stay empty
    mask = rng.random(e) < 0.7
    for m in (None, mask):
        want = np.asarray(r_common.segment_softmax(
            jnp.asarray(logits), jnp.asarray(idx), n, None if m is None else jnp.asarray(m)))
        got = common.segment_softmax(torch.from_numpy(logits), torch.from_numpy(idx), n,
                                     None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    dist = np.abs(rng.normal(size=200) * 4).astype(np.float32)
    dist[0] = 0.0
    np.testing.assert_allclose(
        common.bessel_rbf(torch.from_numpy(dist), 8, 5.0).numpy(),
        np.asarray(r_common.bessel_rbf(jnp.asarray(dist), 8, 5.0)), rtol=1e-5, atol=1e-6)
    x = rng.normal(size=(30, 16)).astype(np.float32)
    np.testing.assert_allclose(common.layer_norm(torch.from_numpy(x)).numpy(),
                               np.asarray(r_common.layer_norm(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


# --- the models on the reference's weights ----------------------------------

def _pair(arch, cell, scale, seed=0):
    """(cfg, ref cfg, port batch, reference batch, port params, reference
    params) at ``reduced()``, the weights the reference's."""
    cfg, ref = get_config(arch).reduced(), r_get_config(arch).reduced()
    host = random_graph_batch(cfg, SHAPES[cell], seed=seed, scale=scale)
    # the reference's functions run jitted: op by op, JAX compiles each
    # primitive for each new shape, several seconds a model
    r_params = jax.jit(lambda k: r_api.init(k, ref, R_SHAPES[cell])[0])(
        jax.random.PRNGKey(seed))
    params = CONVERT[cfg.kind](jax.tree.map(np.asarray, r_params), device="cpu")
    return (cfg, ref, batch_to_device(host, "cpu"),
            {k: jnp.asarray(v) for k, v in host.items()}, params, r_params)


@pytest.mark.parametrize("arch,cell,scale", [
    ("gin-tu", "molecule", 0.05), ("gin-tu", "full_graph_sm", 0.05),
    ("nequip", "molecule", 0.05), ("equiformer-v2", "molecule", 0.05)])
def test_forward_matches_reference(arch, cell, scale):
    cfg, ref, batch, r_batch, params, r_params = _pair(arch, cell, scale)
    graph_level = api.is_graph_level(cfg, SHAPES[cell])
    G = batch["targets"].shape[0] if graph_level else 1
    if cfg.kind == "gin":
        want = jax.jit(lambda p, b: r_gin.forward(p, b, ref, G, node_level=not graph_level))(
            r_params, r_batch)
        got = gin.forward(params, batch, cfg, G, node_level=not graph_level)
    else:
        model, r_model = {"nequip": (nequip, r_nequip),
                          "equiformer_v2": (equiformer, r_equiformer)}[cfg.kind]
        want = jax.jit(lambda p, b: r_model.forward(p, b, ref, G))(r_params, r_batch)
        got = model.forward(params, batch, cfg, G)
    want = np.asarray(want)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    tol = FWD_TOL[cfg.kind]
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("arch,cell,scale", [
    ("gin-tu", "molecule", 0.05), ("gin-tu", "minibatch_lg", 0.005),
    ("nequip", "molecule", 0.05), ("equiformer-v2", "molecule", 0.05)])
def test_loss_and_gradients_match_reference(arch, cell, scale):
    cfg, ref, batch, r_batch, params, r_params = _pair(arch, cell, scale, seed=1)
    (r_loss, r_metrics), r_grads = jax.jit(jax.value_and_grad(
        lambda p, b: r_api.loss_fn(p, b, ref, R_SHAPES[cell]), has_aux=True))(r_params, r_batch)
    (loss, metrics), grads = tree.value_and_grad(
        lambda p: api.loss_fn(p, batch, cfg, SHAPES[cell]), params)
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=1e-5, atol=1e-6)
    assert set(metrics) == set(r_metrics)
    paths, got = tree.flatten_with_paths(grads)
    want = jax.tree.leaves(r_grads)
    assert len(got) == len(want)
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for path, g, w in zip(paths, got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, path
        floored = re.search(FLOORED_LEAVES.get(cfg.kind, "^$"), path) is not None
        largest = float(np.abs(w).max())
        bound = GRAD_TOL * (max(largest, GRAD_FLOOR * scale) if floored else largest)
        assert float(np.abs(g.numpy() - w).max()) <= bound, path


@pytest.mark.parametrize("arch", ["gin-tu", "nequip", "equiformer-v2"])
def test_train_steps_match_reference(arch):
    """The port's init has the reference's tree and shapes; three
    ``make_train_step`` steps (AdamW) on the molecule cell from the
    reference's weights give the reference's losses (1e-4) with finite
    parameters."""
    from repro.optim import AdamW as RAdamW
    from repro_torch.optim import AdamW

    cfg, ref, batch, r_batch, params, r_params = _pair(arch, "molecule", 0.05)
    shape, r_shape = SHAPES["molecule"], R_SHAPES["molecule"]
    fresh = api.init(cfg, shape, seed=0, device="cpu")
    assert jax.tree.map(lambda a: a.shape, r_params) == \
        jax.tree.map(lambda t: tuple(t.shape), fresh)
    r_opt, opt = RAdamW(learning_rate=1e-3), AdamW(learning_rate=1e-3)
    r_state, state = r_opt.init(r_params), opt.init(params)
    r_step = jax.jit(r_api.make_train_step(ref, r_shape, r_opt))
    step = api.make_train_step(cfg, shape, opt)
    for _ in range(3):
        r_params, r_state, r_metrics = r_step(r_params, r_state, r_batch)
        params, state, metrics = step(params, state, batch)
        np.testing.assert_allclose(float(metrics["loss"]), float(r_metrics["loss"]),
                                   rtol=1e-4, atol=1e-6)
    assert all(bool(torch.isfinite(t).all()) for t in tree.leaves(params))


def test_converters_check_the_tree():
    r_params, _ = r_api.init(jax.random.PRNGKey(0), r_get_config("gin-tu").reduced(),
                             R_SHAPES["molecule"])
    tree_np = jax.tree.map(np.asarray, r_params)
    p = convert.gin_params_from_reference(tree_np, device="cpu")
    assert p["layers"][0]["eps"].shape == () and p["layers"][0]["eps"].dtype == torch.float32
    with pytest.raises(ValueError, match="keys"):
        convert.nequip_params_from_reference(tree_np, device="cpu")
    bad = dict(tree_np, layers=[dict(tree_np["layers"][0], eps=np.zeros(1, np.float32))])
    with pytest.raises(ValueError, match="0-d"):
        convert.gin_params_from_reference(bad, device="cpu")
