"""The port's optimizer, schedule and gradient compressor against the JAX
package's, in one process on the CPU, on the same numpy-seeded trees."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.distributed.compression import compress_grads as r_compress_grads
from repro.distributed.compression import init_residuals as r_init_residuals
from repro.distributed.compression import wire_bytes_saved as r_wire_bytes_saved
from repro.optim import AdamW as RAdamW
from repro.optim import cosine_schedule as r_cosine_schedule

from repro_torch.distributed import compress_grads, init_residuals, wire_bytes_saved
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.utils import tree


def _trees(seed, scale=1.0, dtype=np.float32):
    """A params-like tree and a gradient tree of its structure (numpy)."""
    rng = np.random.default_rng(seed)
    shapes = {"embed": (11, 6), "layers": {"w": (3, 6, 5), "b": (3, 5)},
              "head": [(5, 4), (4,)]}

    def draw(s):
        return (rng.normal(size=s) * scale).astype(dtype)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v) for v in node]
        return draw(node)

    return build(shapes), build(shapes)


def _torch(t):
    return tree.map_leaves(lambda a: torch.as_tensor(np.array(a)), t)


def _jax(t):
    return jax.tree.map(jnp.asarray, t)


def _assert_leaves(port, ref, rtol, atol, exact=False):
    got, want = tree.leaves(port), jax.tree.leaves(ref)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.float().numpy() if g.dtype == torch.bfloat16 else g.numpy()
        w = np.asarray(w, dtype=g.dtype)
        if exact:
            assert np.array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def test_tree_flatten_order_and_paths_are_jax():
    params, _ = _trees(0)
    params["opt"] = None
    paths, leaves = tree.flatten_with_paths(_torch(params))
    rpaths = ["/".join(str(k) for k in p) for p, _ in
              jax.tree_util.tree_flatten_with_path(_jax(params))[0]]
    assert paths == rpaths
    assert [tuple(x.shape) for x in leaves] == [x.shape for x in jax.tree.leaves(params)]


@pytest.mark.parametrize("clip,wd,state_dtype", [(1.0, 0.1, "float32"), (None, 0.0, "float32"),
                                                 (0.5, 0.1, "bfloat16")])
def test_adamw_updates_match_reference(clip, wd, state_dtype):
    """Five updates on a float32 tree (constant and cosine learning rates):
    parameters and moments within float32 rounding of the reference's (the
    global norm and float32 pow sum in other orders), the step count
    equal."""
    params, _ = _trees(1)
    kw = dict(clip_norm=clip, weight_decay=wd, state_dtype=state_dtype)
    for lr in (1e-2, "cosine"):
        opt = AdamW(learning_rate=cosine_schedule(1e-2, 2, 5) if lr == "cosine" else lr, **kw)
        ropt = RAdamW(learning_rate=r_cosine_schedule(1e-2, 2, 5) if lr == "cosine" else lr,
                      **kw)
        p, rp = _torch(params), _jax(params)
        s, rs = opt.init(p), ropt.init(rp)
        for i in range(5):
            _, g = _trees(10 + i, scale=3.0)
            p, s = opt.update(p, _torch(g), s)
            rp, rs = ropt.update(rp, _jax(g), rs)
        _assert_leaves(p, rp, rtol=2e-6, atol=2e-7)
        tol = 1e-2 if state_dtype == "bfloat16" else 2e-6
        _assert_leaves(s["m"], rs["m"], rtol=tol, atol=1e-6)
        _assert_leaves(s["v"], rs["v"], rtol=tol, atol=1e-6)
        assert int(s["step"]) == int(rs["step"]) == 5
        assert s["m"]["embed"].dtype == (torch.bfloat16 if state_dtype == "bfloat16"
                                         else torch.float32)


def test_adamw_bf16_params_keep_their_dtype_and_match():
    params, grads = _trees(2)
    p = tree.map_leaves(lambda a: torch.as_tensor(a).to(torch.bfloat16), params)
    rp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    g = tree.map_leaves(lambda a: torch.as_tensor(a).to(torch.bfloat16), grads)
    rg = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), grads)
    opt, ropt = AdamW(learning_rate=1e-2), RAdamW(learning_rate=1e-2)
    p2, s2 = opt.update(p, g, opt.init(p))
    rp2, _ = ropt.update(rp, rg, ropt.init(rp))
    assert all(x.dtype == torch.bfloat16 for x in tree.leaves(p2))
    assert all(x.dtype == torch.float32 for x in tree.leaves(s2["m"]))
    # one bf16 rounding of the new parameters apart at most
    _assert_leaves(p2, jax.tree.map(lambda a: a.astype(jnp.float32), rp2),
                   rtol=2.0 ** -7, atol=1e-6)


def test_adamw_inplace_is_the_functional_update_bitwise():
    params, _ = _trees(3)
    opt = AdamW(learning_rate=cosine_schedule(1e-2, 2, 6))
    a = _torch(params)
    b = _torch(params)
    sa, sb = opt.init(a), opt.init(b)
    ids = [id(x) for x in tree.leaves(b)]
    for i in range(4):
        _, g = _trees(20 + i)
        a, sa = opt.update(a, _torch(g), sa)
        b, sb = opt.update(b, _torch(g), sb, inplace=True)
    assert [id(x) for x in tree.leaves(b)] == ids          # written in place
    for x, y in zip(tree.leaves((a, sa["m"], sa["v"])), tree.leaves((b, sb["m"], sb["v"]))):
        assert torch.equal(x, y)
    # the functional update leaves its arguments as they were
    before = [x.clone() for x in tree.leaves(a)]
    opt.update(a, _torch(_trees(30)[1]), sa)
    assert all(torch.equal(x, y) for x, y in zip(before, tree.leaves(a)))


def test_cosine_schedule_matches_reference():
    lr, rlr = cosine_schedule(3e-4, 10, 100), r_cosine_schedule(3e-4, 10, 100)
    steps = np.arange(0, 120, dtype=np.int32)
    got = np.array([float(lr(torch.tensor(s))) for s in steps], np.float32)
    want = np.asarray(jax.vmap(rlr)(jnp.asarray(steps)), np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] == 0.0 and got[10] == np.float32(3e-4)


def test_compress_grads_bitwise():
    """Three rounds of int8 quantisation with error feedback: the
    decompressed gradients and the residuals equal the reference's bit for
    bit (round half to even on both sides), on float32 and bf16 leaves."""
    params, _ = _trees(4)
    for dtype in (torch.float32, torch.bfloat16):
        jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        p = tree.map_leaves(lambda a: torch.as_tensor(a).to(dtype), params)
        rp = jax.tree.map(lambda a: jnp.asarray(a, jdt), params)
        res, rres = init_residuals(p), r_init_residuals(rp)
        for i in range(3):
            _, g = _trees(40 + i, scale=1e-3)
            g[("embed")][0, :2] = [127 * 1e-3 / 2, -0.5e-3]      # halfway cases
            gt = tree.map_leaves(lambda a: torch.as_tensor(a).to(dtype), g)
            rg = jax.tree.map(lambda a: jnp.asarray(a, jdt), g)
            out, res = compress_grads(gt, res)
            rout, rres = r_compress_grads(rg, rres)
            _assert_leaves(out, rout, 0, 0, exact=True)
            _assert_leaves(res, rres, 0, 0, exact=True)
    assert wire_bytes_saved(_torch(params)) == r_wire_bytes_saved(_jax(params))

