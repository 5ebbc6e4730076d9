"""The LM loss on DTensors, each rank on its own rows and slice of the
vocabulary (``models/layers.py::_ShardedCrossEntropy``, and the embedding's
``_EmbedRows``), against the JAX package's ``cross_entropy`` and
``jax.grad`` of it.

On 4 spawned gloo ranks (``launch/mesh.py::run_ranks``), over a (2, 2) and
a (1, 4) ``("data", "model")`` mesh, the vocabulary split over ``model``:

* ``cross_entropy`` of numpy-seeded logits laid out as the LM head lays
  them out (rows over ``data``, the vocabulary over ``model``), with labels
  on every slice boundary, in the first and in the last slice: the loss and
  the logits' gradient, on every rank, and each rank's gradient shard of
  its own rows and slice alone;
* a reduced qwen3-4b's ``loss_fn`` and every gradient leaf
  (``transformer.value_and_grad``, its parameters laid out by
  ``param_logical_axes``) on numpy-seeded tokens.

The loss within 1e-5 (relative), each gradient within 1e-4 of its leaf's
largest value: float32 on both sides, sums in other orders."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.models import layers as r_layers
from repro.models import transformer as r_tf

import repro_torch.models.transformer as tf
from repro_torch.distributed.sharding import (activation_sharding, constrain,
                                              tree_shardings)
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import layers
from repro_torch.utils import tree
from test_torch_train_grads import _lm_batch
from test_torch_transformer import _both

LOSS_RTOL = 1e-5
GRAD_ATOL = 1e-4          # of each leaf's largest value
MESHES = [(2, 2), (1, 4)]
B, S, V = 4, 6, 64


def _logits_and_labels(seed=3):
    """(B, S, V) logits and (B, S) labels: every boundary of a 2- and a 4-way
    split of V on both sides, the first and the last id, the rest random."""
    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.standard_normal((B, S, V))).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    edges = [0, V // 4 - 1, V // 4, V // 2 - 1, V // 2, 3 * V // 4 - 1, 3 * V // 4, V - 1]
    labels.reshape(-1)[:len(edges)] = edges
    labels[-1, -1] = V - 1                               # the last slice, the last row
    return logits, labels


def _mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))


def _rank(rank, n_ranks, shape, logits, labels, arch):
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    mesh = _mesh(shape)
    out = {}
    # cross_entropy on logits laid out as the LM head lays them out
    with activation_sharding(mesh):
        x = constrain(torch.from_numpy(logits), "batch", None, "vocab").detach()
        y = constrain(torch.from_numpy(labels), "batch", None)
    x.requires_grad_()
    loss = layers.cross_entropy(x, y)
    (g,) = torch.autograd.grad(loss, [x])
    out["ce"] = (float(loss.detach().full_tensor()), g.full_tensor().numpy(),
                 [str(p) for p in x.placements], [str(p) for p in g.placements],
                 tuple(g.to_local().shape))
    # a reduced LM's loss and every gradient leaf
    _, _, pcfg, params = _both(arch)
    shardings = tree_shardings(mesh, tf.param_logical_axes(pcfg), params)
    flat, paths = tree.leaves(params), tree.leaves(shardings)
    dist = tree.unflatten(params, [distribute_tensor(p.detach(), mesh, s.placements)
                                   for p, s in zip(flat, paths)])
    # as the dry-run runs a step: constants (rotary tables) replicated
    with activation_sharding(mesh), implicit_replication():
        batch = {k: constrain(torch.as_tensor(v), "batch", None)
                 for k, v in _lm_batch(pcfg, batch=4, seq=8).items()}
        (total, metrics), grads = tf.value_and_grad(dist, batch, pcfg)
    out["lm"] = (float(total.detach().full_tensor()),
                 float(metrics["loss"].detach().full_tensor()),
                 [g.full_tensor().numpy() for g in tree.leaves(grads)],
                 [str(p) for p in dist["embed"].placements])
    return out


@pytest.fixture(scope="module", params=MESHES, ids=["2x2", "1x4"])
def ranks(request, tmp_path_factory):
    """``(mesh shape, each rank's results)``, run once a mesh for the module's
    tests."""
    logits, labels = _logits_and_labels()
    return request.param, run_ranks(_rank, 4, tmp_path_factory.mktemp("ranks"),
                                    args=(request.param, logits, labels, "qwen3-4b"))


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=GRAD_ATOL * max(float(np.abs(want).max()), 1e-12),
                               err_msg=what)


def test_cross_entropy_on_vocab_shards(ranks):
    """The loss and the logits' gradient on every rank equal the reference's
    ``cross_entropy`` and ``jax.grad`` of it; the gradient keeps the
    logits' layout, each rank holding its own rows and slice."""
    logits, labels = _logits_and_labels()
    want = r_layers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    want_g = jax.grad(r_layers.cross_entropy)(jnp.asarray(logits), jnp.asarray(labels))
    shape, results = ranks
    for r in results:
        loss, g, x_pl, g_pl, local = r["ce"]
        np.testing.assert_allclose(loss, float(want), rtol=LOSS_RTOL)
        _close(g, want_g, "d logits")
        assert x_pl == ["S(0)", "S(2)"] and g_pl == x_pl
        assert local == (B // shape[0], S, V // shape[1])


def test_lm_loss_and_gradients_on_vocab_shards(ranks):
    """A reduced qwen3-4b's ``loss_fn`` and every gradient leaf, its
    parameters laid out by ``param_logical_axes`` (the embedding split over
    the vocabulary), equal ``jax.value_and_grad`` of the reference's on
    every rank."""
    rcfg, rparams, pcfg, _ = _both("qwen3-4b")
    batch = _lm_batch(pcfg, batch=4, seq=8)
    (r_total, r_metrics), r_grads = jax.value_and_grad(
        lambda p: r_tf.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()}, rcfg),
        has_aux=True)(rparams)
    want = jax.tree.leaves(r_grads)
    shape, results = ranks
    for r in results:
        total, loss, grads, embed_pl = r["lm"]
        np.testing.assert_allclose(total, float(r_total), rtol=LOSS_RTOL)
        np.testing.assert_allclose(loss, float(r_metrics["loss"]), rtol=LOSS_RTOL)
        assert len(grads) == len(want)
        for i, (g, w) in enumerate(zip(grads, want)):
            assert g.shape == np.asarray(w).shape
            _close(g, w, f"leaf {i}")
        assert embed_pl == ["S(1)", "S(0)"] if shape[0] > 1 else embed_pl[1] == "S(0)"


def test_plain_tensors_take_the_plain_loss():
    """Plain tensors: ``cross_entropy`` is the float32 log-sum-exp less the
    gathered gold logit, bit for bit."""
    logits, labels = _logits_and_labels()
    x, y = torch.from_numpy(logits), torch.from_numpy(labels)
    plain = torch.mean(torch.logsumexp(x, -1) - torch.gather(x, -1, y.long()[..., None])[..., 0])
    assert torch.equal(layers.cross_entropy(x, y), plain)
