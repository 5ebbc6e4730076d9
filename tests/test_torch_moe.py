"""The port's mixture-of-experts layer (``models/moe.py``) against the JAX
package's.

Twins of ``tests/test_moe.py``'s forward tests (finite and shaped, capacity
drops, high capacity keeps everything, the sharded path equal to the plain
one, ``apply_auto`` picking it), and, on the reference's weights and the
same numpy-seeded tokens: ``apply`` held to the reference's ``moe.apply``
within the reference suite's 2e-5 after the routing indices are asserted
equal, with its aux values; a shared-expert case; top-k ties broken toward
the lower expert id as ``jax.lax.top_k`` breaks them; and ``apply_sharded``
over 1, 2 and 4 spawned gloo ranks (``launch/mesh.py::run_ranks``) against
``apply``.  The gradient test waits for the training slice."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.configs.base import MoEConfig as RMoEConfig
from repro.models import moe as r_moe

from repro_torch.configs.base import MoEConfig
from repro_torch.launch.mesh import Transport, run_ranks
from repro_torch.models import moe

D, T = 32, 64
CFG = dict(n_experts=8, top_k=2, d_expert_ff=16, capacity_factor=2.0)
#: the reference suite's tolerance (sums run in other orders)
TOL = 2e-5


def _params(cfg_kw, seed=0):
    """The reference's init (numpy arrays) for ``MoEConfig(**cfg_kw)``."""
    p, _ = r_moe.init(jax.random.PRNGKey(seed), D, RMoEConfig(**cfg_kw), jnp.float32)
    return jax.tree.map(lambda a: np.asarray(a).copy(), p)


def _torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _x(seed=1, t=T):
    return np.random.default_rng(seed).standard_normal((t, D)).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    return MoEConfig(**CFG), _torch(_params(CFG)), torch.from_numpy(_x())


def _ref_experts(p, x, k):
    probs = jax.nn.softmax((jnp.asarray(x) @ jnp.asarray(p["router"]["w"])
                            ).astype(jnp.float32), axis=-1)
    return np.asarray(jax.lax.top_k(probs, k)[1])


# ---------------------------------------------------------------------------
# tests/test_moe.py's forward tests
# ---------------------------------------------------------------------------


def test_moe_output_finite_and_shaped(setup):
    cfg, params, x = setup
    out, aux = moe.apply(params, x, cfg)
    assert out.shape == x.shape and out.dtype == x.dtype
    assert torch.isfinite(out).all()
    assert float(aux["moe_aux_loss"]) > 0
    assert 0.0 <= float(aux["moe_dropped_frac"]) <= 1.0


def test_moe_capacity_drops(setup):
    cfg, params, x = setup
    _, aux = moe.apply(params, x, cfg, capacity=1)    # capacity 1 drops most
    assert float(aux["moe_dropped_frac"]) > 0.5


def test_moe_high_capacity_keeps_everything(setup):
    cfg, params, x = setup
    _, aux = moe.apply(params, x, cfg, capacity=x.shape[0] * cfg.top_k)
    assert float(aux["moe_dropped_frac"]) == 0.0


class _OneRank:
    """A transport of one rank in this process (sums over one rank)."""

    rank, size = 0, 1

    def all_reduce(self, t, key=None):
        return t.clone()


def test_sharded_path_matches_plain(setup):
    """The expert-parallel path on one rank equals the plain path; both
    accept the whole expert stack or the rank's own."""
    cfg, params, x = setup
    out, aux = moe.apply(params, x, cfg)
    sh, sh_aux = moe.apply_sharded(params, x, cfg, _OneRank())
    assert torch.equal(sh, out)
    assert all(torch.equal(sh_aux[k], aux[k]) for k in aux)
    with pytest.raises(ValueError, match="holds 3 experts"):
        moe.apply_sharded(dict(params, gate=params["gate"][:3]), x, cfg, _OneRank())


def test_apply_auto_picks_sharded(setup, monkeypatch):
    cfg, params, x = setup
    calls = []
    sharded = moe.apply_sharded
    monkeypatch.setattr(moe, "apply_sharded",
                        lambda *a, **kw: calls.append(a[3]) or sharded(*a, **kw))
    out, _ = moe.apply(params, x, cfg)
    one = _OneRank()
    assert torch.equal(moe.apply_auto(params, x, cfg, one)[0], out)
    assert calls == [one]
    assert torch.equal(moe.apply_auto(params, x, cfg)[0], out)
    three = _OneRank()
    three.size = 3                      # 8 experts do not divide over 3 ranks
    assert torch.equal(moe.apply_auto(params, x, cfg, three)[0], out)
    assert calls == [one]


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

CASES = [
    (CFG, None),
    (CFG, 1),                                           # most assignments dropped
    (CFG, T * CFG["top_k"]),                            # every assignment kept
    (dict(CFG, capacity_factor=1.25), None),            # MoEConfig's default factor
    (dict(n_experts=6, top_k=3, d_expert_ff=8, n_shared=2), None),   # shared experts
    (dict(n_experts=16, top_k=4, d_expert_ff=16, n_shared=1, capacity_factor=0.5),
     None),
]


@pytest.mark.parametrize("cfg_kw,capacity", CASES,
                         ids=["cf2", "cap1", "keep-all", "cf1.25", "shared2", "shared1-cf0.5"])
def test_apply_matches_reference(cfg_kw, capacity):
    tree, x = _params(cfg_kw, seed=3), _x(seed=4)
    cfg, rcfg = MoEConfig(**cfg_kw), RMoEConfig(**cfg_kw)
    params = _torch(tree)
    r = moe.route(params, torch.from_numpy(x), cfg)
    assert r.experts.dtype == torch.int64
    assert np.array_equal(r.experts.numpy(), _ref_experts(tree, x, cfg.top_k))
    want, r_aux = r_moe.apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), rcfg,
                              capacity=capacity)
    got, aux = moe.apply(params, torch.from_numpy(x), cfg, capacity=capacity)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    assert float(aux["moe_dropped_frac"]) == float(r_aux["moe_dropped_frac"])
    for k in ("moe_aux_loss", "moe_z_loss"):
        np.testing.assert_allclose(float(aux[k]), float(r_aux[k]), rtol=1e-5)
    if capacity == 1:
        assert float(aux["moe_dropped_frac"]) > 0.5
    if cfg.n_shared:
        assert set(params) == {"router", "gate", "up", "down", "shared"}


def test_dropped_assignments_are_the_latest_tokens():
    """Stable dispatch: an expert over capacity keeps its earliest tokens,
    as the reference's stable ``argsort`` does — the combine adds nothing
    for a dropped assignment."""
    cfg = MoEConfig(n_experts=4, top_k=1, d_expert_ff=8, capacity_factor=1.0)
    tree = _params(dict(n_experts=4, top_k=1, d_expert_ff=8), seed=5)
    tree["router"]["w"][:] = 0
    tree["router"]["w"][0, 2] = 1.0       # every token with x[:, 0] > 0 -> expert 2
    x = np.abs(_x(seed=6, t=12))
    got, aux = moe.apply(_torch(tree), torch.from_numpy(x), cfg)  # C = 3
    want, r_aux = r_moe.apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
                              RMoEConfig(n_experts=4, top_k=1, d_expert_ff=8,
                                         capacity_factor=1.0))
    assert float(aux["moe_dropped_frac"]) == float(r_aux["moe_dropped_frac"]) == 0.75
    assert torch.count_nonzero(got[:3].abs().sum(1)) == 3
    assert torch.count_nonzero(got[3:]) == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_top_k_ties_go_to_the_lower_expert_id():
    """Exact ties, as bf16 router logits make them at olmoe's width: the
    reference's ``lax.top_k`` order (the lower id first), on every row."""
    E, K = 8, 3
    tree = _params(dict(n_experts=E, top_k=K, d_expert_ff=8), seed=7)
    w = tree["router"]["w"]
    w[:, 5] = w[:, 2]                     # experts 2 and 5 always tie
    w[:, 7] = w[:, 1]                     # and 1 and 7
    x = _x(seed=8)
    x[:4] = 0.0                           # all eight experts tie
    cfg = MoEConfig(n_experts=E, top_k=K, d_expert_ff=8)
    got = moe.route(_torch(tree), torch.from_numpy(x), cfg).experts.numpy()
    want = _ref_experts(tree, x, K)
    assert np.array_equal(got, want)
    assert (got[:4] == [0, 1, 2]).all()
    for row in got:
        for a, b in ((2, 5), (1, 7)):
            if a in row and b in row:
                assert list(row).index(a) < list(row).index(b)
    assert any(2 in row and 5 in row for row in got)
    got_out, _ = moe.apply(_torch(tree), torch.from_numpy(x), cfg)
    want_out, _ = r_moe.apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
                              RMoEConfig(n_experts=E, top_k=K, d_expert_ff=8))
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), rtol=TOL, atol=TOL)


def test_init_shapes_and_seed():
    cfg = MoEConfig(n_experts=6, top_k=2, d_expert_ff=8, n_shared=1)
    a = moe.init(D, cfg, seed=0, device="cpu")
    shapes = jax.tree.map(lambda t: tuple(t.shape), a)
    want = jax.tree.map(lambda t: tuple(t.shape),
                        r_moe.init(jax.random.PRNGKey(0), D, RMoEConfig(6, 2, 8, 1),
                                   jnp.float32)[0])
    assert shapes == want
    b = moe.init(D, cfg, seed=0, device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(jax.tree.leaves(a), jax.tree.leaves(b)))
    assert moe.init(D, cfg, dtype=torch.bfloat16, device="cpu")["gate"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# expert parallelism over gloo ranks
# ---------------------------------------------------------------------------


def _rank_moe(rank, n_ranks, tree, x, cfg_kw):
    import torch.distributed as dist

    cfg = MoEConfig(**cfg_kw)
    tp = Transport(dist.group.WORLD, torch.device("cpu"))
    params = _torch(tree)
    xt = torch.from_numpy(x)
    out, aux = moe.apply_sharded(params, xt, cfg, tp)
    E_loc = cfg.n_experts // n_ranks
    lo = rank * E_loc
    own = dict(params, **{k: params[k][lo:lo + E_loc].clone()
                          for k in ("gate", "up", "down")})
    out_own, _ = moe.apply_sharded(own, xt, cfg, tp)
    out_auto, _ = moe.apply_auto(params, xt, cfg, tp)
    return (out.numpy(), {k: float(v) for k, v in aux.items()},
            torch.equal(out_own, out), torch.equal(out_auto, out))


@pytest.mark.parametrize("n_ranks", [1, 2, 4])
def test_sharded_over_gloo_ranks_matches_apply(n_ranks, tmp_path):
    cfg_kw = dict(n_experts=8, top_k=2, d_expert_ff=16, n_shared=1, capacity_factor=1.0)
    tree, x = _params(cfg_kw, seed=9), _x(seed=10)
    cfg = MoEConfig(**cfg_kw)
    want, aux = moe.apply(_torch(tree), torch.from_numpy(x), cfg)
    assert float(aux["moe_dropped_frac"]) > 0       # capacity bites across ranks
    results = run_ranks(_rank_moe, n_ranks, tmp_path, args=(tree, x, cfg_kw))
    for out, r_aux, own_equal, auto_equal in results:
        np.testing.assert_allclose(out, want.numpy(), rtol=TOL, atol=TOL)
        assert r_aux["moe_dropped_frac"] == float(aux["moe_dropped_frac"])
        for k in ("moe_aux_loss", "moe_z_loss"):
            assert r_aux[k] == float(aux[k])
        assert own_equal and auto_equal
    assert all(np.array_equal(r[0], results[0][0]) for r in results)


@pytest.mark.parametrize("capacity", [None, 1, 5])
def test_kept_is_the_dispatch(setup, capacity):
    """``kept``: the assignments ``apply`` gives a slot, as many as its
    dropped fraction leaves, and an expert's earliest tokens."""
    cfg, params, x = setup
    r = moe.route(params, x, cfg)
    keep = moe.kept(r.experts, cfg, capacity)
    _, aux = moe.apply(params, x, cfg, capacity)
    assert keep.shape == r.experts.shape and keep.dtype == torch.bool
    assert float(aux["moe_dropped_frac"]) == 1.0 - keep.float().mean()
    C = moe.capacity_of(x.shape[0], cfg, capacity)
    for e in range(cfg.n_experts):
        hits = (r.experts == e).nonzero()          # (token, k) in token order
        assert keep[hits[:, 0], hits[:, 1]].tolist() == [i < C for i in range(len(hits))]
