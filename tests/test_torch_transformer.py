"""The port's LM transformer against the JAX package's, for reduced
qwen3-4b, gemma3-4b, qwen2.5-14b and the mixture-of-experts olmoe-1b-7b and
kimi-k2-1t-a32b in float32, on the same weights
(carried by ``repro_torch.convert.lm_params_from_reference``) and the same
numpy-seeded tokens.  On the CPU, prefill attention takes the
``flash_attention`` wrapper's plain version; the kernel itself is checked on
the card (tests/test_torch_cuda.py).

The port runs ``reduced_for_port()`` (``reduced()`` with d_head 32, the
kernel's smallest head size; ``reduced()`` gives 16) and the JAX package
the same config; gemma3's takes ``global_every=2`` so that one of its two
layers is global.

A MoE model's routing is captured layer by layer on both sides (the JAX
package's forward runs under ``jax.disable_jit`` so that its layer loop
hands concrete arrays to the spy) and held equal before any output is
compared."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.configs.registry import get_config as r_get_config
from repro.configs.registry import shapes_for as r_shapes_for
from repro.data.lm import TokenPipeline as RTokenPipeline
from repro.models import layers as r_layers
from repro.models import transformer as r_tf

import repro_torch.models.transformer as tf
from repro_torch.configs.base import LM_SHAPES
from repro_torch.configs.registry import get_config, shapes_for
from repro_torch.convert import lm_params_from_reference
from repro_torch.data.lm import TokenPipeline
from repro_torch.models import layers, moe

DENSE_ARCHS = ["qwen3-4b", "gemma3-4b", "qwen2.5-14b"]
MOE_ARCHS = ["olmoe-1b-7b", "kimi-k2-1t-a32b"]
ARCHS = DENSE_ARCHS + MOE_ARCHS
#: float32 on both sides; sums run in other orders (attention: one softmax
#: block on this side, chunked online softmax on JAX's)
RTOL, ATOL = 1e-4, 1e-5
B, S = 2, 40          # 40 tokens: more than the reduced chunk (32) and window (16)


def _configs(arch):
    pcfg = get_config(arch).reduced_for_port()
    if pcfg.sliding_window:
        pcfg = dataclasses.replace(pcfg, global_every=2)
    rcfg = dataclasses.replace(r_get_config(arch).reduced(), d_head=pcfg.d_head,
                               global_every=pcfg.global_every)
    return rcfg, pcfg


def _tree(rcfg, seed):
    """The reference's init with its biases and norm scales made random, so
    that they matter."""
    tree = jax.tree.map(np.asarray, r_tf.init(jax.random.PRNGKey(seed), rcfg)[0])
    rng = np.random.default_rng(seed)
    attn, lay = tree["layers"]["attn"], tree["layers"]
    for name in ("bq", "bk", "bv"):
        if name in attn:
            attn[name] = rng.normal(scale=0.1, size=attn[name].shape).astype(np.float32)
    for d, name in ((attn, "q_norm"), (attn, "k_norm"), (lay, "ln1"), (lay, "ln2"),
                    (tree["final_norm"], "scale")):
        if name in d:
            d[name] = (1 + 0.1 * rng.normal(size=d[name].shape)).astype(np.float32)
    return tree


def _both(arch, seed=0):
    rcfg, pcfg = _configs(arch)
    tree = _tree(rcfg, seed)
    return (rcfg, jax.tree.map(jnp.asarray, tree), pcfg,
            lm_params_from_reference(tree, pcfg, device="cpu"))


def _tokens(cfg, batch, seq, seed=1):
    return next(TokenPipeline(cfg.vocab, batch, seq, seed=seed))["tokens"]


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


class _Routing:
    """Each MoE call's top-k experts and aux values, on both sides."""

    def __init__(self):
        self.port, self.ref = [], []

    def assert_equal(self):
        assert len(self.port) == len(self.ref)
        for (pe, pa), (re, ra) in zip(self.port, self.ref):
            assert np.array_equal(pe, re)                  # routing first
            assert pa["moe_dropped_frac"] == ra["moe_dropped_frac"]

    @property
    def dropped(self):
        """Whether any MoE call dropped an assignment."""
        return any(float(a["moe_dropped_frac"]) > 0 for _, a in self.port)


@contextlib.contextmanager
def _routing(monkeypatch):
    """Record every MoE call's routing in both packages; the reference runs
    un-jitted meanwhile (its layer scan as a Python loop)."""
    seen = _Routing()
    port_auto, ref_auto = tf.moe_lib.apply_auto, r_tf.moe_lib.apply_auto

    def port_spy(fp, x, cfg):
        out, aux = port_auto(fp, x, cfg)
        seen.port.append((moe.route(fp, x, cfg).experts.numpy(),
                          {k: float(v) for k, v in aux.items()}))
        return out, aux

    def ref_spy(fp, x, cfg):
        out, aux = ref_auto(fp, x, cfg)
        probs = jax.nn.softmax(
            (x @ fp["router"]["w"].astype(x.dtype)).astype(jnp.float32), axis=-1)
        seen.ref.append((np.asarray(jax.lax.top_k(probs, cfg.top_k)[1]),
                         {k: float(v) for k, v in aux.items()}))
        return out, aux

    monkeypatch.setattr(tf.moe_lib, "apply_auto", port_spy)
    monkeypatch.setattr(r_tf.moe_lib, "apply_auto", ref_spy)
    with jax.disable_jit():
        yield seen


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, monkeypatch):
    rcfg, rparams, pcfg, pparams = _both(arch)
    tokens = _tokens(pcfg, B, S)
    with _routing(monkeypatch) as seen:
        r_logits, r_aux, r_cache = r_tf.forward(rparams, jnp.asarray(tokens), rcfg,
                                                return_cache=True)
        logits, aux, cache = tf.forward(pparams, torch.from_numpy(tokens), pcfg,
                                        return_cache=True)
    seen.assert_equal()
    assert len(seen.port) == (pcfg.n_layers if pcfg.moe else 0)
    assert logits.shape == (B, S, pcfg.vocab)
    assert aux.keys() == r_aux.keys() == (
        {"moe_aux_loss", "moe_z_loss", "moe_dropped_frac"} if pcfg.moe else set())
    _close(logits, r_logits)
    _close(cache["k"], r_cache["k"])
    _close(cache["v"], r_cache["v"])
    assert cache["pos"] == int(r_cache["pos"]) == S
    plain, again = tf.forward(pparams, torch.from_numpy(tokens), pcfg)
    assert torch.equal(plain, logits)
    assert all(torch.equal(again[k], aux[k]) for k in aux)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_empty_cache_matches_reference(arch, monkeypatch):
    rcfg, rparams, pcfg, pparams = _both(arch, seed=2)
    toks = _tokens(pcfg, B, 3, seed=3)
    r_cache = r_tf.init_cache(rcfg, B, 8)
    cache = tf.init_cache(pcfg, B, 8, device="cpu")
    with _routing(monkeypatch) as seen:
        for t in range(3):
            step = toks[:, t:t + 1]
            r_logits, r_cache = r_tf.decode_step(rparams, r_cache, jnp.asarray(step),
                                                 rcfg)
            logits, cache = tf.decode_step(pparams, cache, torch.from_numpy(step), pcfg)
            seen.assert_equal()
            assert logits.shape == (B, 1, pcfg.vocab)
            _close(logits, r_logits)
            _close(cache["k"], r_cache["k"])
            _close(cache["v"], r_cache["v"])
            assert cache["pos"] == int(r_cache["pos"]) == t + 1
    assert len(seen.port) == (3 * pcfg.n_layers if pcfg.moe else 0)


def _no_drops(arch):
    """The MoE configuration with a capacity factor of E / K: every expert
    has a slot for every token, so no assignment is ever dropped."""
    rcfg, pcfg = _configs(arch)
    e, k = pcfg.moe.n_experts, pcfg.moe.top_k
    return (dataclasses.replace(rcfg, moe=dataclasses.replace(rcfg.moe, capacity_factor=e / k)),
            dataclasses.replace(pcfg, moe=dataclasses.replace(pcfg.moe, capacity_factor=e / k)))


HAND_OFF = ([(a, False) for a in ARCHS] + [(a, True) for a in MOE_ARCHS])


@pytest.mark.parametrize("arch,no_drops", HAND_OFF,
                         ids=[a + ("-no-drops" if n else "") for a, n in HAND_OFF])
def test_prefill_to_decode_hand_off(arch, no_drops, monkeypatch):
    """Prefill S tokens, copy the cache into an empty one of S + 3 slots and
    decode 3 greedy tokens: the logits and caches match the JAX package's
    same flow (a MoE model's routing equal on both sides), and each step's
    logits match the port's own prefill over the tokens so far.

    A MoE model's capacity depends on its batch (T = B at a decode step,
    B·S in the prefill), so a decode step may drop a token's assignment that
    the prefill kept, or the other way round, in the JAX package as in the
    port.  The step is held to the prefill's last row only where no MoE call
    of the flow dropped an assignment; the ``no_drops`` case (capacity
    factor E / K) always is."""
    if no_drops:
        rcfg, pcfg = _no_drops(arch)
        tree = _tree(rcfg, 4)
        rparams = jax.tree.map(jnp.asarray, tree)
        pparams = lm_params_from_reference(tree, pcfg, device="cpu")
    else:
        rcfg, rparams, pcfg, pparams = _both(arch, seed=4)
    with _routing(monkeypatch) as seen:
        _hand_off(rcfg, rparams, pcfg, pparams, seen)
    if no_drops:
        assert not seen.dropped and seen.port


def _hand_off(rcfg, rparams, pcfg, pparams, seen):
    tokens = _tokens(pcfg, B, S, seed=5)
    r_logits, _, r_pre = r_tf.forward(rparams, jnp.asarray(tokens), rcfg,
                                      return_cache=True)
    logits, _, pre = tf.forward(pparams, torch.from_numpy(tokens), pcfg,
                                return_cache=True)
    r_cache = r_tf.init_cache(rcfg, B, S + 3)
    r_cache = {"k": r_cache["k"].at[:, :, :S].set(r_pre["k"]),
               "v": r_cache["v"].at[:, :, :S].set(r_pre["v"]), "pos": r_pre["pos"]}
    cache = tf.init_cache(pcfg, B, S + 3, device="cpu")
    cache["k"][:, :, :S] = pre["k"]
    cache["v"][:, :, :S] = pre["v"]
    cache["pos"] = pre["pos"]
    seq = torch.from_numpy(tokens).long()
    nxt = logits[:, -1:].argmax(-1)
    assert torch.equal(nxt, torch.tensor(np.asarray(r_logits[:, -1:].argmax(-1))).long())
    for _ in range(3):
        r_logits, r_cache = r_tf.decode_step(rparams, r_cache, jnp.asarray(nxt.numpy()), rcfg)
        logits, cache = tf.decode_step(pparams, cache, nxt, pcfg)
        seen.assert_equal()
        _close(logits, r_logits)
        _close(cache["k"], r_cache["k"])
        _close(cache["v"], r_cache["v"])
        seq = torch.cat([seq, nxt], dim=1)
        n = len(seen.port)
        full, aux = tf.forward(pparams, seq, pcfg)
        del seen.port[n:]                        # the port's own prefill
        if not seen.dropped and float(aux.get("moe_dropped_frac", 0)) == 0:
            _close(logits[:, 0], full[:, -1])
        nxt = logits.argmax(-1)
    assert cache["pos"] == S + 3


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_calls_the_kernel_wrapper_once_per_layer(arch, monkeypatch):
    _, _, pcfg, pparams = _both(arch)
    calls = []
    wrapped = tf.flash_attention

    def spy(q, k, v, causal=True, window=None):
        calls.append((tuple(q.shape), tuple(k.shape), causal, window))
        return wrapped(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(tf, "flash_attention", spy)
    tf.forward(pparams, torch.from_numpy(_tokens(pcfg, B, S)), pcfg)
    H, KV, Dh = pcfg.n_heads, pcfg.n_kv_heads, pcfg.d_head
    windows = [None if g else pcfg.sliding_window for g in tf.is_global_layer(pcfg)]
    assert calls == [((B, S, H, Dh), (B, S, KV, Dh), True, w) for w in windows]
    if pcfg.sliding_window:
        assert windows == [16, None]              # gemma3: a local and a global layer


@pytest.mark.parametrize("causal,window,window_dynamic,q_offset,kv_len", [
    (True, None, None, 60, (65, 66)),
    (True, None, 17, 60, (65, 66)),
    (True, 9, None, 60, (64, 66)),
    (True, None, 1 << 30, 0, None),
    (False, None, 17, 40, None),
    (True, None, None, 0, None),
])
def test_layers_attention_matches_reference(causal, window, window_dynamic, q_offset,
                                            kv_len):
    """The chunked twin (decode's attention) against JAX's, over 70 keys in
    chunks of 32 (a padded tail), GQA 4 query heads on 2 KV heads."""
    rng = np.random.default_rng(q_offset + (window or 0) + (window_dynamic or 0) % 97)
    Sq = 5 if q_offset else 70
    q = rng.normal(size=(2, Sq, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 70, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 70, 2, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset, chunk=32)
    r_kw = dict(kw, kv_len=None if kv_len is None else jnp.asarray(kv_len, jnp.int32),
                window_dynamic=None if window_dynamic is None
                else jnp.asarray(window_dynamic, jnp.int32))
    want = r_layers.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **r_kw)
    got = layers.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           kv_len=None if kv_len is None else torch.tensor(kv_len),
                           window_dynamic=window_dynamic, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_norms_and_rope_match_reference():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 7, 4, 32)).astype(np.float32)
    scale = rng.normal(size=(32,)).astype(np.float32)
    pos = np.arange(3, 10)
    t = torch.from_numpy
    _close(layers.rms_norm({"scale": t(scale)}, t(x)),
           r_layers.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
    _close(layers.rms_norm_nd(t(scale), t(x)),
           r_layers.rms_norm_nd(jnp.asarray(scale), jnp.asarray(x)))
    _close(layers.apply_rope(t(x), t(pos), 1e6),
           r_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    _close(layers.swiglu(t(x), t(x[::-1].copy())),
           r_layers.swiglu(jnp.asarray(x), jnp.asarray(x[::-1])))


def test_token_pipeline_bitwise_equal_to_reference():
    mine, ref = TokenPipeline(151936, 3, 257, seed=7), RTokenPipeline(151936, 3, 257, seed=7)
    for _ in range(3):
        a, b = next(mine), next(ref)
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key])


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    mine, ref = get_config(arch), r_get_config(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.n_params() == ref.n_params()
    assert dataclasses.asdict(mine.reduced()) == dataclasses.asdict(ref.reduced())
    assert [s.name for s in shapes_for(arch)] == [s.name for s in r_shapes_for(arch)]
    assert [(s.name, s.kind, s.dims) for s in LM_SHAPES] == [
        (s.name, s.kind, s.dims) for s in ref.shapes]


def test_qwen3_4b_parameter_count():
    cfg = get_config("qwen3-4b")
    # n_params counts no QK-norm scales (2 x 36 x 128 of them)
    assert cfg.n_params() + 2 * cfg.n_layers * cfg.d_head == 4_411_424_256


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_for_port_is_reduced_at_the_kernels_head_size(arch):
    cfg = get_config(arch)
    assert dataclasses.asdict(cfg.reduced_for_port()) == dataclasses.asdict(
        dataclasses.replace(cfg.reduced(), d_head=32))
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="head size must be one of"):
        tf.forward(tf.init(cfg.reduced(), seed=0, device="cpu"), tokens, cfg.reduced())
    logits, _ = tf.forward(tf.init(cfg.reduced_for_port(), seed=0, device="cpu"), tokens,
                           cfg.reduced_for_port())
    assert logits.shape == (1, 4, cfg.reduced().vocab)


def test_lm_params_from_reference_defaults_to_the_card(monkeypatch):
    rcfg, pcfg = _configs("qwen3-4b")
    tree = _tree(rcfg, 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm_params_from_reference(tree, pcfg)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_aux_equals_the_reference(arch, monkeypatch):
    """The aux dict of a MoE forward: each value the reference's mean over
    layers (dropped fraction exactly, the losses within float32 rounding),
    with the routing equal layer by layer."""
    rcfg, rparams, pcfg, pparams = _both(arch, seed=6)
    tokens = _tokens(pcfg, 3, 24, seed=7)
    with _routing(monkeypatch) as seen:
        _, r_aux = r_tf.forward(rparams, jnp.asarray(tokens), rcfg)
        _, aux = tf.forward(pparams, torch.from_numpy(tokens), pcfg)
    seen.assert_equal()
    assert sorted(aux) == sorted(r_aux) == ["moe_aux_loss", "moe_dropped_frac",
                                            "moe_z_loss"]
    for k in aux:
        assert aux[k].dtype == torch.float32 and aux[k].shape == ()
    assert float(aux["moe_dropped_frac"]) == float(r_aux["moe_dropped_frac"])
    for k in ("moe_aux_loss", "moe_z_loss"):
        assert float(aux[k]) == pytest.approx(float(r_aux[k]), rel=1e-5)
    per_layer = [a for _, a in seen.port]
    for k in aux:
        assert float(aux[k]) == pytest.approx(
            sum(a[k] for a in per_layer) / pcfg.n_layers, rel=1e-6)


def test_init_draws_the_reference_shapes_on_the_cpu():
    for arch in ARCHS:
        rcfg, pcfg = _configs(arch)
        rtree = r_tf.init(jax.random.PRNGKey(0), rcfg)[0]
        mine = tf.init(pcfg, seed=0, device="cpu")
        shapes = jax.tree.map(lambda a: tuple(a.shape), rtree)
        assert jax.tree.map(lambda t: tuple(t.shape), mine) == shapes
        assert all(t.dtype == torch.float32 for t in jax.tree.leaves(mine))
        again = tf.init(pcfg, seed=0, device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(mine),
                                                       jax.tree.leaves(again)))


def test_decode_step_raises_past_the_cache():
    _, _, pcfg, pparams = _both("qwen3-4b")
    cache = tf.init_cache(pcfg, 1, 2, device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.int32)
    for _ in range(2):
        _, cache = tf.decode_step(pparams, cache, tok, pcfg)
    with pytest.raises(ValueError, match="outside the cache"):
        tf.decode_step(pparams, cache, tok, pcfg)


@pytest.mark.parametrize("edit,match", [
    (lambda t: t.pop("lm_head"), "params has keys"),
    (lambda t: t["layers"]["attn"].pop("k_norm"), "layers.attn has keys"),
    (lambda t: t["layers"]["attn"].update(bq=np.zeros(128, np.float32)),
     "layers.attn has keys"),
    (lambda t: t["layers"]["attn"].pop("wq"), "layers.attn has keys"),
    (lambda t: t["layers"]["ffn"].update(router={"w": np.zeros((2, 2), np.float32)}),
     "layers.ffn has keys"),
    (lambda t: t["layers"].update(ln1=t["layers"]["ln1"].astype(np.float64)),
     "expected float32"),
])
def test_lm_params_from_reference_checks_the_tree(edit, match):
    rcfg, pcfg = _configs("qwen3-4b")
    tree = _tree(rcfg, 0)
    edit(tree)
    with pytest.raises(ValueError, match=match):
        lm_params_from_reference(tree, pcfg, device="cpu")


def _ffn_edit(fn):
    return lambda t: fn(t["layers"]["ffn"])


@pytest.mark.parametrize("arch,edit,match", [
    ("olmoe-1b-7b", _ffn_edit(lambda f: f.pop("router")), "layers.ffn has keys"),
    ("olmoe-1b-7b", _ffn_edit(lambda f: f.update(shared=f["router"])),
     "layers.ffn has keys"),
    ("olmoe-1b-7b", _ffn_edit(lambda f: f["router"].update(b=f["router"]["w"])),
     "layers.ffn.router has keys"),
    ("kimi-k2-1t-a32b", _ffn_edit(lambda f: f.pop("shared")), "layers.ffn has keys"),
    ("kimi-k2-1t-a32b", _ffn_edit(lambda f: f["shared"].pop("down")),
     "layers.ffn.shared has keys"),
    ("kimi-k2-1t-a32b", _ffn_edit(lambda f: f.update(gate=f["gate"].astype(np.float64))),
     "expected float32"),
])
def test_lm_params_from_reference_checks_the_moe_tree(arch, edit, match):
    rcfg, pcfg = _configs(arch)
    tree = _tree(rcfg, 0)
    assert lm_params_from_reference(tree, pcfg, device="cpu")["layers"]["ffn"].keys() \
        == tree["layers"]["ffn"].keys()
    edit(tree)
    with pytest.raises(ValueError, match=match):
        lm_params_from_reference(tree, pcfg, device="cpu")
