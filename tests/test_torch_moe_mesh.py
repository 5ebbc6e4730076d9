"""The port's MoE mesh route (``models/moe.py::apply_mesh``) against the JAX
package's ``moe.apply_sharded``.

Twins of ``tests/test_moe.py``'s ``test_sharded_path_matches_plain``,
``test_apply_auto_uses_ctx`` and ``test_grad_flows_through_sharded`` on a
1 x 1 ``("data", "model")`` mesh of one in-process gloo rank, on the
reference's weights and numpy-seeded tokens, at the reference suite's
tolerance; then a (2, 2) mesh over 4 spawned gloo ranks
(``launch/mesh.py::run_ranks``), held to the reference's ``moe.apply`` on
each data row's tokens at the row's capacity, its three losses to the
rows' mean."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.configs.base import MoEConfig as RMoEConfig
from repro.distributed.sharding import activation_sharding as r_activation_sharding
from repro.distributed.sharding import rules_for as r_rules_for
from repro.models import moe as r_moe

from repro_torch.configs.base import MoEConfig
from repro_torch.distributed.sharding import activation_sharding, constrain, rules_for
from repro_torch.launch.mesh import make_smoke_mesh, run_ranks
from repro_torch.models import moe

D, T = 32, 64
CFG = dict(n_experts=8, top_k=2, d_expert_ff=16, capacity_factor=2.0)
#: the reference suite's tolerance (sums run in other orders)
TOL = 2e-5
AUX = ("moe_aux_loss", "moe_z_loss", "moe_dropped_frac")


def _params(cfg_kw, seed=0):
    p, _ = r_moe.init(jax.random.PRNGKey(seed), D, RMoEConfig(**cfg_kw), jnp.float32)
    return jax.tree.map(lambda a: np.asarray(a).copy(), p)


def _torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _x(seed=1, t=T):
    return np.random.default_rng(seed).standard_normal((t, D)).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    tree = _params(CFG)
    mesh = make_smoke_mesh(1, device="cpu")
    r_mesh = jax.make_mesh((1, 1), ("data", "model"))
    return MoEConfig(**CFG), tree, _x(), mesh, r_mesh


def test_sharded_path_matches_plain(setup):
    """On a 1 x 1 mesh the route is ``apply`` bit for bit, and within the
    reference suite's tolerance of the reference's ``apply_sharded``."""
    cfg, tree, x, mesh, r_mesh = setup
    params, xt = _torch(tree), torch.from_numpy(x)
    out, aux = moe.apply_mesh(params, xt, cfg, mesh, rules_for(mesh))
    plain, plain_aux = moe.apply(params, xt, cfg)
    assert isinstance(out, torch.Tensor) and torch.equal(out, plain)
    assert all(torch.equal(aux[k], plain_aux[k]) for k in AUX)
    with r_mesh:
        r_out, r_aux = jax.jit(lambda p, xx: r_moe.apply_sharded(
            p, xx, RMoEConfig(**CFG), r_mesh, r_rules_for(r_mesh)))(tree, x)
    np.testing.assert_allclose(out.numpy(), np.asarray(r_out), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(aux["moe_aux_loss"]), float(r_aux["moe_aux_loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(aux["moe_z_loss"]), float(r_aux["moe_z_loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(aux["moe_dropped_frac"]),
                               float(r_aux["moe_dropped_frac"]), atol=1e-6)


def test_apply_auto_uses_ctx(setup, monkeypatch):
    cfg, tree, x, mesh, r_mesh = setup
    calls = []
    route = moe.apply_mesh
    monkeypatch.setattr(moe, "apply_mesh", lambda *a, **kw: calls.append(a[3]) or route(*a, **kw))
    params = _torch(tree)
    with activation_sharding(mesh):
        xd = constrain(torch.from_numpy(x), "batch", None)
        out, _ = moe.apply_auto(params, xd, cfg)
    assert calls == [mesh]
    assert torch.equal(out.full_tensor(), moe.apply(params, torch.from_numpy(x), cfg)[0])
    assert moe.apply_auto(params, torch.from_numpy(x), cfg)[0].shape == (T, D)
    assert calls == [mesh]                           # no context: the plain path
    with r_mesh:
        with r_activation_sharding(r_mesh):
            r_out, _ = jax.jit(lambda p, xx: r_moe.apply_auto(p, xx, RMoEConfig(**CFG)))(tree, x)
    np.testing.assert_allclose(out.full_tensor().numpy(), np.asarray(r_out), rtol=TOL, atol=TOL)


def test_grad_flows_through_sharded(setup):
    """Every gradient leaf finite, the experts' non-zero, and each within
    1e-4 of its largest value of ``jax.grad`` of the reference's route."""
    cfg, tree, x, mesh, r_mesh = setup
    flat, spec = jax.tree.flatten(tree)
    live = [torch.from_numpy(a.copy()).requires_grad_() for a in flat]
    params = jax.tree.unflatten(spec, live)
    out, aux = moe.apply_mesh(params, torch.from_numpy(x), cfg, mesh, rules_for(mesh))
    grads = torch.autograd.grad((out ** 2).sum() + aux["moe_aux_loss"], live)
    assert all(torch.isfinite(g).all() for g in grads)
    assert float(jax.tree.unflatten(spec, grads)["gate"].abs().max()) > 0

    def loss(p):
        o, a = r_moe.apply_sharded(p, x, RMoEConfig(**CFG), r_mesh, r_rules_for(r_mesh))
        return jnp.sum(o ** 2) + a["moe_aux_loss"]

    with r_mesh:
        r_grads = jax.tree.leaves(jax.jit(jax.grad(loss))(tree))
    for g, rg in zip(grads, r_grads):
        rg = np.asarray(rg)
        np.testing.assert_allclose(g.numpy(), rg, rtol=0, atol=1e-4 * max(np.abs(rg).max(), 1e-6))


# ---------------------------------------------------------------------------
# a (2, 2) mesh over 4 gloo ranks
# ---------------------------------------------------------------------------


def _rank_mesh(rank, n_ranks, tree, x, cfg_kw):
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = MoEConfig(**cfg_kw)
    with activation_sharding(mesh):
        xd = constrain(torch.from_numpy(x), "batch", None)
        out, aux = moe.apply_auto(_torch(tree), xd, cfg)
    local = tuple(xd.to_local().shape), [str(p) for p in out.placements]
    return out.full_tensor().numpy(), {k: float(aux[k].full_tensor()) for k in AUX}, local


@pytest.mark.parametrize("cfg_kw", [dict(CFG, capacity_factor=1.0),
                                    dict(n_experts=8, top_k=2, d_expert_ff=16, n_shared=1,
                                         capacity_factor=0.5)],
                         ids=["cf1", "shared1-cf0.5"])
def test_mesh_2x2_matches_reference_per_data_row(cfg_kw, tmp_path):
    tree, x = _params(cfg_kw, seed=9), _x(seed=10)
    rcfg = RMoEConfig(**cfg_kw)
    rows = [r_moe.apply(tree, x[i * T // 2:(i + 1) * T // 2], rcfg) for i in range(2)]
    want = np.concatenate([np.asarray(o) for o, _ in rows])
    want_aux = {k: np.mean([np.float32(a[k]) for _, a in rows], dtype=np.float32) for k in AUX}
    assert want_aux["moe_dropped_frac"] > 0          # the rows' capacity bites
    results = run_ranks(_rank_mesh, 4, tmp_path, args=(tree, x, cfg_kw))
    for out, aux, (local_shape, placements) in results:
        assert local_shape == (T // 2, D)            # tokens split over data
        assert placements == ["S(0)", "R"]           # rows over data, whole over model
        np.testing.assert_allclose(out, want, rtol=TOL, atol=TOL)
        for k in AUX:
            np.testing.assert_allclose(aux[k], want_aux[k], rtol=1e-6, atol=1e-7)
    assert all(np.array_equal(r[0], results[0][0]) for r in results)


def _rank_grads(rank, n_ranks, tree, x, cfg_kw):
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    flat, spec = jax.tree.flatten(tree)
    out = []
    for which in ("out", "losses"):
        live = [torch.from_numpy(a.copy()).requires_grad_() for a in flat]
        xt = torch.from_numpy(x.copy()).requires_grad_()
        o, aux = moe.apply_mesh(jax.tree.unflatten(spec, live), xt, MoEConfig(**cfg_kw), mesh,
                                rules_for(mesh))
        loss = (o ** 2).sum() if which == "out" else aux["moe_aux_loss"] + aux["moe_z_loss"]
        # the losses do not reach the experts' weights
        grads = torch.autograd.grad(loss, live + [xt], allow_unused=True)
        out.append([np.zeros(t.shape, np.float32) if g is None else g.numpy()
                    for t, g in zip(live + [xt], grads)])
    return out


def test_mesh_2x2_gradients_match_reference_per_data_row(tmp_path):
    """Every gradient leaf and x's, of the output's squares and of the two
    router losses apart, on the (2, 2) mesh against ``jax.grad`` of the
    reference's ``apply`` over each data row's tokens at ``C(T_loc)``
    (the losses the rows' mean); each within 1e-4 of its largest value.
    The losses' gradients reach the router and x through every model
    shard, so a shard that passed back the whole of them would double
    them here."""
    cfg_kw = dict(CFG, capacity_factor=1.0)
    tree, x = _params(cfg_kw, seed=9), _x(seed=10)
    rcfg = RMoEConfig(**cfg_kw)
    half = T // 2

    def ref_loss(which):
        def loss(p, xx):
            total = 0.0
            for i in range(2):
                o, a = r_moe.apply(p, xx[i * half:(i + 1) * half], rcfg)
                total = total + (jnp.sum(o ** 2) if which == "out"
                                 else (a["moe_aux_loss"] + a["moe_z_loss"]) / 2)
            return total
        return loss

    want = []
    for which in ("out", "losses"):
        gp, gx = jax.grad(ref_loss(which), argnums=(0, 1))(tree, x)
        want.append([np.asarray(a) for a in jax.tree.leaves(gp)] + [np.asarray(gx)])
    assert float(np.abs(want[1][-1]).max()) > 0          # the losses reach x
    results = run_ranks(_rank_grads, 4, tmp_path, args=(tree, x, cfg_kw))
    for per_rank in results:
        for got, ref in zip(per_rank, want):
            assert len(got) == len(ref)
            for g, rg in zip(got, ref):
                np.testing.assert_allclose(g, rg, rtol=0,
                                           atol=1e-4 * max(np.abs(rg).max(), 1e-6))
