"""The port's dense LM transformer against the JAX package's, for reduced
qwen3-4b, gemma3-4b and qwen2.5-14b in float32, on the same weights
(carried by ``repro_torch.convert.lm_params_from_reference``) and the same
numpy-seeded tokens.  On the CPU, prefill attention takes the
``flash_attention`` wrapper's plain version; the kernel itself is checked on
the card (tests/test_torch_cuda.py).

The port runs ``reduced_for_port()`` (``reduced()`` with d_head 32, the
kernel's smallest head size; ``reduced()`` gives 16) and the JAX package
the same config; gemma3's takes ``global_every=2`` so that one of its two
layers is global."""
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
from repro_torch.configs.base import LM_SHAPES, MoEConfig
from repro_torch.configs.registry import get_config, shapes_for
from repro_torch.convert import lm_params_from_reference
from repro_torch.data.lm import TokenPipeline
from repro_torch.models import layers

ARCHS = ["qwen3-4b", "gemma3-4b", "qwen2.5-14b"]
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


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    rcfg, rparams, pcfg, pparams = _both(arch)
    tokens = _tokens(pcfg, B, S)
    r_logits, _, r_cache = r_tf.forward(rparams, jnp.asarray(tokens), rcfg,
                                        return_cache=True)
    logits, aux, cache = tf.forward(pparams, torch.from_numpy(tokens), pcfg,
                                    return_cache=True)
    assert aux == {} and logits.shape == (B, S, pcfg.vocab)
    _close(logits, r_logits)
    _close(cache["k"], r_cache["k"])
    _close(cache["v"], r_cache["v"])
    assert cache["pos"] == int(r_cache["pos"]) == S
    plain, aux = tf.forward(pparams, torch.from_numpy(tokens), pcfg)
    assert torch.equal(plain, logits) and aux == {}


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_empty_cache_matches_reference(arch):
    rcfg, rparams, pcfg, pparams = _both(arch, seed=2)
    toks = _tokens(pcfg, B, 3, seed=3)
    r_cache = r_tf.init_cache(rcfg, B, 8)
    cache = tf.init_cache(pcfg, B, 8, device="cpu")
    for t in range(3):
        step = toks[:, t:t + 1]
        r_logits, r_cache = r_tf.decode_step(rparams, r_cache, jnp.asarray(step), rcfg)
        logits, cache = tf.decode_step(pparams, cache, torch.from_numpy(step), pcfg)
        assert logits.shape == (B, 1, pcfg.vocab)
        _close(logits, r_logits)
        _close(cache["k"], r_cache["k"])
        _close(cache["v"], r_cache["v"])
        assert cache["pos"] == int(r_cache["pos"]) == t + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_to_decode_hand_off(arch):
    """Prefill S tokens, copy the cache into an empty one of S + 3 slots and
    decode 3 greedy tokens: the logits and caches match the JAX package's
    same flow, and each step's logits match the port's own prefill over the
    tokens so far."""
    rcfg, rparams, pcfg, pparams = _both(arch, seed=4)
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
        _close(logits, r_logits)
        _close(cache["k"], r_cache["k"])
        _close(cache["v"], r_cache["v"])
        seq = torch.cat([seq, nxt], dim=1)
        full, _ = tf.forward(pparams, seq, pcfg)
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


def test_mixture_of_experts_waits_for_its_slice():
    cfg = dataclasses.replace(get_config("qwen3-4b").reduced_for_port(),
                              moe=MoEConfig(n_experts=4, top_k=2, d_expert_ff=32))
    with pytest.raises(NotImplementedError, match="MoE slice"):
        tf.init(cfg, seed=0, device="cpu")


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
