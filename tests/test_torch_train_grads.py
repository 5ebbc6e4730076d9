"""The port's training gradients against ``jax.value_and_grad`` of the JAX
package, in one process on the CPU, on the same weights (carried by
``repro_torch.convert``) and the same numpy-seeded batches.

On the CPU the ``flash_attention`` wrapper's backward is the plain explicit
backward (``flash_attention_backward_reference``), the ``embedding_bag``
wrapper's the plain scatter-add, and ``segment_spmm_csr``'s the plain
version over the transposed CSR; the JAX package differentiates its plain
``jnp`` functions.  Both sides run float32 and sum in other orders, so
values are compared within stated tolerances."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.configs.base import GNN_SHAPES as R_GNN_SHAPES
from repro.configs.registry import get_config as r_get_config
from repro.data.graphs import random_graph_batch as r_random_graph_batch
from repro.data.recsys import ClickLogPipeline as RClickLogPipeline
from repro.models import dlrm as r_dlrm
from repro.models import layers as r_layers
from repro.models import transformer as r_tf
from repro.models.gnn import api as r_api
from repro.models.gnn import gcn as r_gcn

import repro_torch.models.transformer as tf
from repro_torch.configs.base import GNN_SHAPES
from repro_torch.configs.registry import get_config
from repro_torch.convert import dlrm_params_from_reference, gcn_params_from_reference
from repro_torch.data.graphs import random_graph_batch
from repro_torch.data.recsys import ClickLogPipeline
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import dlrm, layers
from repro_torch.models.gnn import api, gcn
from repro_torch.utils import tree
from test_torch_transformer import _both, _tokens

#: float32 on both sides, sums in other orders: the loss relative 1e-5;
#: each gradient leaf elementwise within RTOL of itself plus ATOL of the
#: leaf's largest value (small entries are differences of larger terms)
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5


def _grads_close(port_grads, ref_grads):
    paths, got = tree.flatten_with_paths(port_grads)
    want = jax.tree.leaves(ref_grads)
    assert len(got) == len(want)
    for path, g, w in zip(paths, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, path
        scale = float(np.abs(w).max()) or 1.0
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL, atol=GRAD_ATOL * scale,
                                   err_msg=path)


def _lm_batch(cfg, batch=2, seq=40, seed=1):
    toks = _tokens(cfg, batch, seq + 1, seed)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("arch", ["qwen3-4b", "olmoe-1b-7b"])
@pytest.mark.parametrize("remat", [False, True])
def test_lm_loss_and_every_gradient_leaf(arch, remat):
    """reduced_for_port() in float32 (the reference at the same d_head 32):
    the loss, the MoE aux values and every gradient leaf equal
    ``jax.value_and_grad(loss_fn)``'s; remat gives the same gradients."""
    rcfg, rparams, pcfg, params = _both(arch)
    batch = _lm_batch(pcfg)
    (r_total, r_metrics), r_grads = jax.value_and_grad(
        lambda p: r_tf.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()}, rcfg),
        has_aux=True)(rparams)
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    (total, metrics), grads = tf.value_and_grad(params, tbatch, pcfg, remat=remat)
    np.testing.assert_allclose(float(total), float(r_total), rtol=LOSS_RTOL)
    assert set(metrics) == set(r_metrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(r_metrics[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    _grads_close(grads, r_grads)


def test_remat_gradients_equal_plain_bitwise():
    """remat recomputes each layer's forward with the same arithmetic: the
    gradients are the plain run's bit for bit; and taken per layer view,
    then stacked, they are those of the stacked leaves."""
    _, _, pcfg, params = _both("qwen3-4b")
    batch = {k: torch.as_tensor(v) for k, v in _lm_batch(pcfg).items()}
    runs = [tf.value_and_grad(params, batch, pcfg, remat=r) for r in (False, True)]
    assert float(runs[0][0][0]) == float(runs[1][0][0])
    for a, b in zip(tree.leaves(runs[0][1]), tree.leaves(runs[1][1])):
        assert torch.equal(a, b)
    # the same gradients as through the stacked leaves themselves
    whole = tree.value_and_grad(lambda p: tf.loss_fn(p, batch, pcfg), params)[1]
    for a, b in zip(tree.leaves(runs[0][1]), tree.leaves(whole)):
        assert torch.equal(a, b)


#: (b, sq, skv, kv, g, causal, window): causal, windowed, GQA, Sq != Skv,
#: every row with a valid key (the JAX attention averages v over a row with
#: none, the port gives 0)
ATTN_GRAD_CASES = [
    (2, 24, 24, 2, 2, True, None),
    (1, 40, 40, 1, 4, True, 7),
    (1, 20, 36, 2, 1, False, None),
    (2, 36, 20, 1, 2, True, None),
    (1, 30, 50, 2, 2, False, 12),
    (1, 33, 33, 4, 1, True, 64),
]


@pytest.mark.parametrize("case", ATTN_GRAD_CASES)
def test_attention_backward_matches_jax_grad(case):
    """The wrapper's gradient on the CPU (the plain explicit backward from
    the saved log-sum-exp) against ``jax.grad`` of ``models/layers.py``'s
    attention, head size 32."""
    b, sq, skv, kv, g, causal, window = case
    rng = np.random.default_rng(sum(case[:5]))
    q = rng.normal(size=(b, sq, kv * g, 32)).astype(np.float32)
    k = rng.normal(size=(b, skv, kv, 32)).astype(np.float32)
    v = rng.normal(size=(b, skv, kv, 32)).astype(np.float32)
    do = rng.normal(size=q.shape).astype(np.float32)

    def r_loss(q_, k_, v_):
        out = r_layers.attention(q_, k_, v_, causal=causal, window=window, chunk=16)
        return jnp.sum(out * do)

    want = jax.grad(r_loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    qt, kt, vt = (torch.as_tensor(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(qt, kt, vt, causal=causal, window=window)
    assert out.grad_fn is not None
    out.backward(torch.as_tensor(do))
    for got, w in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_plain_attention_backward_gives_zero_on_rows_without_a_key():
    """A row that sees no key (window past Skv) has output 0 and zero q
    gradient, and adds nothing to k and v's."""
    rng = np.random.default_rng(3)
    q = torch.as_tensor(rng.normal(size=(1, 30, 2, 32)), dtype=torch.float32)
    k = torch.as_tensor(rng.normal(size=(1, 20, 1, 32)), dtype=torch.float32)
    v = torch.as_tensor(rng.normal(size=(1, 20, 1, 32)), dtype=torch.float32)
    grads = []
    for rows in (30, 23):      # rows 23.. see no key (kv > q - 4 needs kv >= 20)
        qt, kt, vt = (t.clone().requires_grad_() for t in (q[:, :rows], k, v))
        out = flash_attention(qt, kt, vt, causal=False, window=4)
        out.backward(torch.ones_like(out))
        grads.append((out.detach(), qt.grad, kt.grad, vt.grad))
    (out, dq, dk, dv), (_, dq23, dk23, dv23) = grads
    assert bool((out[:, 23:] == 0).all()) and bool((dq[:, 23:] == 0).all())
    torch.testing.assert_close(dq[:, :23], dq23, rtol=0, atol=0)
    torch.testing.assert_close(dk, dk23, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(dv, dv23, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("multi_hot", [1, 8])
def test_dlrm_loss_and_every_gradient_leaf(multi_hot):
    """dlrm-rm2 reduced(), single- and multi-hot: the BCE loss, accuracy
    and every gradient leaf (the table's dense (V, d) gradient too) equal
    the reference's."""
    cfg = dataclasses.replace(get_config("dlrm-rm2").reduced(), multi_hot=multi_hot)
    rcfg = dataclasses.replace(r_get_config("dlrm-rm2").reduced(), multi_hot=multi_hot)
    rparams = r_dlrm.init(jax.random.PRNGKey(0), rcfg)[0]
    params = dlrm_params_from_reference(jax.tree.map(np.asarray, rparams), device="cpu")
    batch = next(ClickLogPipeline(cfg, 64, seed=3))
    rbatch = next(RClickLogPipeline(rcfg, 64, seed=3))
    (r_loss, r_metrics), r_grads = jax.value_and_grad(
        lambda p: r_dlrm.loss_fn(p, {k: jnp.asarray(v) for k, v in rbatch.items()}, rcfg),
        has_aux=True)(rparams)
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    (loss, metrics), grads = tree.value_and_grad(
        lambda p: dlrm.loss_fn(p, tbatch, cfg), params)
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=LOSS_RTOL)
    assert float(metrics["acc"]) == float(r_metrics["acc"])
    _grads_close(grads, r_grads)


def test_gcn_loss_and_every_gradient_leaf():
    """gcn-cora reduced() on a full_graph_sm batch: the masked loss,
    accuracy and every gradient leaf equal the reference's (x's gradient
    through the transposed segment_spmm)."""
    cfg, rcfg = get_config("gcn-cora").reduced(), r_get_config("gcn-cora").reduced()
    shape = {s.name: s for s in GNN_SHAPES}["full_graph_sm"]
    rshape = {s.name: s for s in R_GNN_SHAPES}["full_graph_sm"]
    batch = random_graph_batch(cfg, shape, seed=2, scale=0.05)
    rbatch = r_random_graph_batch(rcfg, rshape, seed=2, scale=0.05)
    rparams = r_api.init(jax.random.PRNGKey(1), rcfg, rshape)[0]
    params = gcn_params_from_reference(jax.tree.map(np.asarray, rparams), device="cpu")
    (r_loss, r_metrics), r_grads = jax.value_and_grad(
        lambda p: r_api.loss_fn(p, {k: jnp.asarray(v) for k, v in rbatch.items()}, rcfg,
                                rshape), has_aux=True)(rparams)
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    csr = gcn.graph_csr(tbatch)
    (loss, metrics), grads = tree.value_and_grad(
        lambda p: api.loss_fn(p, tbatch, cfg, shape, csr), params)
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=LOSS_RTOL)
    assert float(metrics["accuracy"]) == float(r_metrics["accuracy"])
    _grads_close(grads, r_grads)
    assert r_gcn.loss_fn is not None and len(csr._transposed) == 1


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(3, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    want = float(r_layers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(layers.cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_dense_and_norm_init_shapes_and_apply():
    gen = torch.Generator().manual_seed(0)
    p = layers.dense_init(gen, 6, 5, torch.bfloat16, bias=True)
    assert p["w"].shape == (6, 5) and p["w"].dtype == torch.bfloat16
    assert p["b"].shape == (5,) and not p["b"].any()
    rp, _ = r_layers.dense_init(jax.random.PRNGKey(0), 6, 5, jnp.float32, bias=True)
    x = np.random.default_rng(0).normal(size=(4, 6)).astype(np.float32)
    want = np.asarray(r_layers.dense_apply(rp, jnp.asarray(x)))
    got = layers.dense_apply({k: torch.as_tensor(np.asarray(v)) for k, v in rp.items()},
                             torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert float(p["w"].float().std()) == pytest.approx(1 / 6 ** 0.5, rel=0.5)
    assert torch.equal(layers.norm_init(5, torch.float32)["scale"], torch.ones(5))


@pytest.mark.parametrize("model", ["dlrm", "gcn"])
def test_train_steps_match_reference(model):
    """Two ``make_train_step`` steps (AdamW, lr 1e-2) of reduced DLRM
    (multi-hot 4) and of the GCN on carried weights and the same batches:
    each step's loss and the parameters after within float32 rounding of
    the reference's steps, the update written into the parameters the step
    was given."""
    from repro.optim import AdamW as RAdamW

    from repro_torch.optim import AdamW

    opt, ropt = AdamW(learning_rate=1e-2), RAdamW(learning_rate=1e-2)
    if model == "dlrm":
        cfg = dataclasses.replace(get_config("dlrm-rm2").reduced(), multi_hot=4)
        rcfg = dataclasses.replace(r_get_config("dlrm-rm2").reduced(), multi_hot=4)
        rparams = r_dlrm.init(jax.random.PRNGKey(2), rcfg)[0]
        params = dlrm_params_from_reference(jax.tree.map(np.asarray, rparams), device="cpu")
        rstep = jax.jit(r_dlrm.make_train_step(rcfg, ropt))
        step = dlrm.make_train_step(cfg, opt)
        pipe = ClickLogPipeline(cfg, 32, seed=4)
        batches = [next(pipe) for _ in range(2)]
    else:
        cfg, rcfg = get_config("gcn-cora").reduced(), r_get_config("gcn-cora").reduced()
        shape = {s.name: s for s in GNN_SHAPES}["full_graph_sm"]
        rshape = {s.name: s for s in R_GNN_SHAPES}["full_graph_sm"]
        batch = random_graph_batch(cfg, shape, seed=3, scale=0.05)
        rparams = r_api.init(jax.random.PRNGKey(3), rcfg, rshape)[0]
        params = gcn_params_from_reference(jax.tree.map(np.asarray, rparams), device="cpu")
        rstep = jax.jit(r_api.make_train_step(rcfg, rshape, ropt))
        csr = gcn.graph_csr({k: torch.as_tensor(v) for k, v in batch.items()})
        step = api.make_train_step(cfg, shape, opt, csr=csr)
        batches = [batch, batch]
    p, s = params, opt.init(params)
    ids = [id(x) for x in tree.leaves(params)]
    losses = []
    for b in batches:
        p, s, m = step(p, s, {k: torch.as_tensor(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    assert [id(x) for x in tree.leaves(p)] == ids          # written in place
    rp, rs = rparams, ropt.init(rparams)
    for i, b in enumerate(batches):
        rp, rs, rm = rstep(rp, rs, {k: jnp.asarray(v) for k, v in b.items()})
        np.testing.assert_allclose(losses[i], float(rm["loss"]), rtol=1e-5)
    for g, w in zip(tree.leaves(p), jax.tree.leaves(rp)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
