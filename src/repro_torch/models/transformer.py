"""Decoder-only LM transformer, on tensors: prefill and decode.

The JAX package's ``models/transformer.py``: GQA, QK-norm (qwen3, gemma3,
olmoe), QKV bias (qwen2.5), sliding-window with periodic global layers
(gemma3), and the mixture-of-experts FFN (olmoe, kimi-k2; ``moe.py``) on
each layer's ``(B·S, d)`` tokens, its aux values averaged over layers.  Parameters are a plain dict of tensors in
the JAX package's layout, layers stacked along a leading L axis; the layer
loop is a Python loop over the stack (JAX's ``lax.scan``).  The logical
axes of the parameters and the KV cache are the JAX package's, for
``repro_torch.distributed.sharding``, and the activations are constrained
where the JAX package's are (``constrain``: a no-op outside
``activation_sharding``, where a dry-run on DTensors lays them out; the
projections to heads are laid out before their split, as a DTensor cannot
split a dim that is sharded over more chips than it has heads).

Prefill attention runs as the hand-written ``flash_attention`` CUDA kernel
(one launch per layer), with ``window`` the configuration's sliding window
on local layers and none on global ones, as the JAX layer's
``window_dynamic = where(is_glob, 1 << 30, sliding_window)``.  Decode
attends over the KV cache with ``layers.attention`` (``q_offset=pos``,
``kv_len=pos + 1``), as the JAX package does.  Products are
``torch.matmul``, as the JAX package leaves them to XLA.

Entry points:
  init(cfg, seed, device)              -> params
  param_logical_axes(cfg)              -> logical axes of ``init``'s tree
  forward(params, tokens, cfg, ...)    -> (logits, aux) or (logits, aux, cache)
  init_cache(cfg, batch, max_len, ...) -> KV cache {"k", "v", "pos"}
  cache_logical_axes(cfg, long_context) -> logical axes of the cache
  decode_step(params, cache, tokens, cfg) -> (logits, cache)
  loss_fn(params, batch, cfg, remat)   -> (total loss, metrics)
  value_and_grad(params, batch, cfg, remat) -> ((total, metrics), grads)
  make_train_step(cfg, optimizer, remat) -> step(params, opt_state, batch)

Training takes its gradients with ``torch.autograd.grad`` (the JAX
package's ``jax.value_and_grad``); the attention's backward is the
``flash_attention`` wrapper's, a hand-written kernel on the card.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import constrain
from repro_torch.kernels import is_dtensor
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (apply_rope, attention, cross_entropy, embed_rows,
                                       rms_norm, rms_norm_nd, swiglu)
from repro_torch.utils import tree

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _dtype(cfg: LMConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init(cfg: LMConfig, seed: int = 0, device: DeviceLike = None) -> Dict:
    """Random parameters from ``seed``, drawn on ``device`` (default CUDA)
    with the JAX package's shapes and scales (normal / sqrt(fan_in); norm
    scales 1, biases 0).  The draws differ from JAX's for the same seed."""
    dev = resolve_device(device)
    dt = _dtype(cfg)
    d, H, KV, Dh, F, V, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.d_head, cfg.d_ff, cfg.vocab, cfg.n_layers)
    gen = torch.Generator(device=dev).manual_seed(seed)
    s_d = 1.0 / math.sqrt(d)

    def nrm(shape, scale):
        t = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return t.mul_(scale).to(dt)

    def const(shape, value):
        return torch.full(shape, value, dtype=dt, device=dev)

    attn = {
        "wq": nrm((L, d, H * Dh), s_d),
        "wk": nrm((L, d, KV * Dh), s_d),
        "wv": nrm((L, d, KV * Dh), s_d),
        "wo": nrm((L, H * Dh, d), 1.0 / math.sqrt(H * Dh)),
    }
    if cfg.attn_bias:
        attn.update(bq=const((L, H * Dh), 0.0), bk=const((L, KV * Dh), 0.0),
                    bv=const((L, KV * Dh), 0.0))
    if cfg.qk_norm:
        attn.update(q_norm=const((L, Dh), 1.0), k_norm=const((L, Dh), 1.0))
    if cfg.moe:
        E, Fe, Sh = cfg.moe.n_experts, cfg.moe.d_expert_ff, cfg.moe.n_shared
        ffn = {
            "router": {"w": nrm((L, d, E), s_d)},
            "gate": nrm((L, E, d, Fe), s_d),
            "up": nrm((L, E, d, Fe), s_d),
            "down": nrm((L, E, Fe, d), 1.0 / math.sqrt(Fe)),
        }
        if Sh:
            ffn["shared"] = {
                "gate": nrm((L, Sh, d, Fe), s_d),
                "up": nrm((L, Sh, d, Fe), s_d),
                "down": nrm((L, Sh, Fe, d), 1.0 / math.sqrt(Fe)),
            }
    else:
        ffn = {
            "gate": nrm((L, d, F), s_d),
            "up": nrm((L, d, F), s_d),
            "down": nrm((L, F, d), 1.0 / math.sqrt(F)),
        }
    params = {
        "embed": nrm((V, d), 1.0),
        "layers": {"attn": attn, "ffn": ffn, "ln1": const((L, d), 1.0),
                   "ln2": const((L, d), 1.0)},
        "final_norm": {"scale": const((d,), 1.0)},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = nrm((d, V), s_d)
    return params


def param_logical_axes(cfg: LMConfig) -> Dict:
    """The logical axis names of each dimension of :func:`init`'s tree (the
    JAX package's ``init`` returns them beside the parameters): ``fsdp`` on
    a matrix's model dimension, ``model`` / ``ffn`` / ``experts`` / ``vocab``
    on the tensor-parallel one, the stacked layer axis unsharded."""
    attn = {"wq": (None, "fsdp", "model"), "wk": (None, "fsdp", "model"),
            "wv": (None, "fsdp", "model"), "wo": (None, "model", "fsdp")}
    if cfg.attn_bias:
        attn.update(bq=(None, "model"), bk=(None, "model"), bv=(None, "model"))
    if cfg.qk_norm:
        attn.update(q_norm=(None, None), k_norm=(None, None))
    if cfg.moe:
        ffn = {"router": {"w": (None, "fsdp", None)},
               "gate": (None, "experts", "fsdp", None),
               "up": (None, "experts", "fsdp", None),
               "down": (None, "experts", None, "fsdp")}
        if cfg.moe.n_shared:
            ffn["shared"] = {"gate": (None, None, "fsdp", "model"),
                             "up": (None, None, "fsdp", "model"),
                             "down": (None, None, "model", "fsdp")}
    else:
        ffn = {"gate": (None, "fsdp", "ffn"), "up": (None, "fsdp", "ffn"),
               "down": (None, "ffn", "fsdp")}
    logical = {
        "embed": ("vocab", "fsdp"),
        "layers": {"attn": attn, "ffn": ffn, "ln1": (None, None), "ln2": (None, None)},
        "final_norm": {"scale": (None,)},
    }
    if not cfg.tie_embeddings:
        logical["lm_head"] = ("fsdp", "vocab")
    return logical


def is_global_layer(cfg: LMConfig) -> List[bool]:
    """Per layer: True where the layer uses global (non-windowed) attention."""
    if cfg.sliding_window is None:
        return [True] * cfg.n_layers
    if cfg.global_every <= 0:
        return [False] * cfg.n_layers
    return [i % cfg.global_every == cfg.global_every - 1 for i in range(cfg.n_layers)]


def _layer_params(params: Dict, i: int) -> Dict:
    def at(tree):
        if isinstance(tree, dict):
            return {k: at(t) for k, t in tree.items()}
        return tree[i]

    return at(params["layers"])


def _split_heads(t: torch.Tensor, n: int, d_head: int, axis: str) -> torch.Tensor:
    """(B, S, n·Dh) -> (B, S, n, Dh), constrained ``batch`` x ``axis``."""
    B, S, _ = t.shape
    t = constrain(t, "batch", None, axis, shape=(B, S, n))
    return constrain(t.reshape(B, S, n, d_head), "batch", None, axis, None)


def _qkv(cfg: LMConfig, h: torch.Tensor, ap: Dict):
    """q (B, S, H, Dh), k and v (B, S, KV, Dh) before rotary embedding."""
    q = h @ ap["wq"].to(h.dtype)
    k = h @ ap["wk"].to(h.dtype)
    v = h @ ap["wv"].to(h.dtype)
    if cfg.attn_bias:
        q = q + ap["bq"].to(h.dtype)
        k = k + ap["bk"].to(h.dtype)
        v = v + ap["bv"].to(h.dtype)
    q = _split_heads(q, cfg.n_heads, cfg.d_head, "heads")
    k = _split_heads(k, cfg.n_kv_heads, cfg.d_head, "kv_heads")
    v = _split_heads(v, cfg.n_kv_heads, cfg.d_head, "kv_heads")
    if cfg.qk_norm:
        q = rms_norm_nd(ap["q_norm"], q, cfg.norm_eps)
        k = rms_norm_nd(ap["k_norm"], k, cfg.norm_eps)
    return q, k, v


def _ffn(cfg: LMConfig, x: torch.Tensor, lp: Dict):
    """The FFN's output for x (B, S, d) and its aux dict (empty when dense):
    a MoE configuration routes the ``B·S`` tokens as one batch."""
    h2 = rms_norm({"scale": lp["ln2"]}, x, cfg.norm_eps)
    fp = lp["ffn"]
    if cfg.moe:
        B, S, d = h2.shape
        flat = constrain(h2.reshape(B * S, d), "batch", None)
        y, aux = moe_lib.apply_auto(fp, flat, cfg.moe)
        return y.reshape(B, S, d), aux
    h_ff = constrain(swiglu(h2 @ fp["gate"].to(h2.dtype), h2 @ fp["up"].to(h2.dtype)),
                     "batch", None, "ffn")
    return h_ff @ fp["down"].to(h2.dtype), {}


def _head(params: Dict, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return constrain(x @ head.to(x.dtype), "batch", None, "vocab")


def _embed(params: Dict, tokens: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    table = params["embed"].to(_dtype(cfg))
    if is_dtensor(table):   # each rank looks up its own rows
        tokens = constrain(tokens, "batch", None)
    x = constrain(embed_rows(table, tokens), "batch", None, None)
    if cfg.tie_embeddings:
        x = x * math.sqrt(cfg.d_model)
    return x


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------


def _layer(cfg: LMConfig, x: torch.Tensor, lp: Dict, is_glob: bool):
    """One layer over the whole sequence; returns (x, aux, k, v), k after
    its rotary embedding (the cache's content)."""
    B, S, _ = x.shape
    h = rms_norm({"scale": lp["ln1"]}, x, cfg.norm_eps)
    q, k, v = _qkv(cfg, h, lp["attn"])
    pos = torch.arange(S, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    window = None if is_glob else cfg.sliding_window
    o = flash_attention(q, k, v, causal=True, window=window)
    x = constrain(x + o.reshape(B, S, -1) @ lp["attn"]["wo"].to(x.dtype), "batch", None, None)
    y, aux = _ffn(cfg, x, lp)
    return constrain(x + y, "batch", None, None), aux, k, v


def _layer_no_cache(cfg: LMConfig, x: torch.Tensor, lp: Dict, is_glob: bool):
    x, aux, _, _ = _layer(cfg, x, lp, is_glob)
    return x, aux


def forward(params: Dict, tokens: torch.Tensor, cfg: LMConfig,
            return_cache: bool = False, remat: bool = False):
    """Logits (B, S, vocab) for tokens (B, S); with ``return_cache`` also
    the KV cache {"k", "v": (L, B, S, KV, Dh), "pos": S}.  ``aux`` is the
    JAX package's auxiliary-loss dict: empty for a dense model, for a MoE
    model each of ``moe_aux_loss``, ``moe_z_loss`` and ``moe_dropped_frac``
    averaged over layers (float32 scalars).

    ``remat`` recomputes each layer's forward in the backward instead of
    keeping its activations: one ``torch.utils.checkpoint`` per layer (the
    JAX package's ``jax.checkpoint`` of its layer body).  The numbers do not
    change: the recomputed forward relaunches the same deterministic
    kernels."""
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    cache = None
    # a DTensor cannot be copied into a slice of a plain stack: a dry-run's
    # layers' keys and values are stacked once at the end instead
    stacked = return_cache and is_dtensor(x)
    if return_cache:
        if remat:
            raise ValueError("forward: remat and return_cache do not go together")
        shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.d_head)
        cache = ({"k": [], "v": [], "pos": S} if stacked else
                 {"k": torch.empty(shape, dtype=x.dtype, device=x.device),
                  "v": torch.empty(shape, dtype=x.dtype, device=x.device), "pos": S})
    aux_sum: Dict[str, torch.Tensor] = {}
    for i, glob in enumerate(is_global_layer(cfg)):
        lp = _layer_params(params, i)
        if remat:
            x, aux = checkpoint(_layer_no_cache, cfg, x, lp, glob, use_reentrant=False)
            k = v = None
        else:
            x, aux, k, v = _layer(cfg, x, lp, glob)
        for name, value in aux.items():
            aux_sum[name] = aux_sum[name] + value if name in aux_sum else value
        if stacked:
            cache["k"].append(k)
            cache["v"].append(v)
        elif cache is not None:
            cache["k"][i], cache["v"][i] = k, v
    if stacked:
        cache.update(k=torch.stack(cache["k"]), v=torch.stack(cache["v"]))
    logits = _head(params, x, cfg)
    aux = {name: value / cfg.n_layers for name, value in aux_sum.items()}
    return (logits, aux, cache) if return_cache else (logits, aux)


# ---------------------------------------------------------------------------
# decode (one token against a KV cache)
# ---------------------------------------------------------------------------


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> Dict:
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
            "v": torch.zeros(shape, dtype=_dtype(cfg), device=dev), "pos": 0}


def cache_logical_axes(cfg: LMConfig, long_context: bool = False) -> Dict:
    """KV-cache sharding: batch over data; sequence over whatever mesh axes
    remain (the rules dedupe per-array mesh-axis reuse, so batched decode's
    seq dim picks up only ``model`` while batch-1 long-context decode takes
    the full mesh).  kv_heads rarely divides the model axis (4-8 heads vs 16
    shards) — the divisibility fallback then drops it."""
    batch_axis = None if long_context else "batch"
    return {
        "k": (None, batch_axis, "kv_seq", "kv_heads", None),
        "v": (None, batch_axis, "kv_seq", "kv_heads", None),
        "pos": (),
    }


def decode_step(params: Dict, cache: Dict, tokens: torch.Tensor, cfg: LMConfig):
    """One decode step: tokens (B, 1) -> (logits (B, 1, vocab), cache).
    A MoE layer routes the step's B tokens as one batch (so with the JAX
    package's capacity, colliding tokens can be dropped where a prefill
    kept them).

    Writes the new keys and values into ``cache["k"]``/``cache["v"]`` in
    place at ``cache["pos"]`` (the JAX package returns updated copies) and
    returns the cache with ``pos + 1``.  Raises when the cache is full,
    where JAX's ``dynamic_update_slice`` would clamp the write onto the
    last slot."""
    pos = int(cache["pos"])
    max_len = cache["k"].shape[2]
    if not 0 <= pos < max_len:
        raise ValueError(f"decode_step: position {pos} outside the cache's "
                         f"{max_len} slots")
    B = tokens.shape[0]
    x = _embed(params, tokens, cfg)                  # (B, 1, d)
    positions = torch.full((1,), pos, device=x.device)
    for i, glob in enumerate(is_global_layer(cfg)):
        lp = _layer_params(params, i)
        h = rms_norm({"scale": lp["ln1"]}, x, cfg.norm_eps)
        q, k, v = _qkv(cfg, h, lp["attn"])
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        # the query heads laid out as the KV heads they read (a no-op
        # outside a dry-run), so that their groups split alike
        q = constrain(q, "batch", None, "kv_heads", None,
                      shape=(B, 1, cfg.n_kv_heads, cfg.d_head))
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        k_cache[:, pos] = k[:, 0].to(k_cache.dtype)
        v_cache[:, pos] = v[:, 0].to(v_cache.dtype)
        window_dyn = None
        if cfg.sliding_window is not None:
            window_dyn = (1 << 30) if glob else cfg.sliding_window
        o = attention(q, k_cache, v_cache, causal=True, q_offset=pos,
                      window_dynamic=window_dyn, chunk=cfg.attention_chunk,
                      kv_len=torch.full((B,), pos + 1, device=x.device))
        x = x + o.reshape(B, 1, -1) @ lp["attn"]["wo"].to(x.dtype)
        x = x + _ffn(cfg, x, lp)[0]
    logits = _head(params, x, cfg)
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def loss_fn(params, batch, cfg: LMConfig, remat: bool = False):
    """``(total, metrics)``: the mean token cross-entropy of
    ``batch["labels"]`` under ``batch["tokens"]``, plus the MoE auxiliary
    and z losses when the model has them (``metrics``: ``loss`` and the aux
    values)."""
    logits, aux = forward(params, batch["tokens"], cfg, remat=remat)
    loss = cross_entropy(logits, batch["labels"])
    total = loss
    for k in ("moe_aux_loss", "moe_z_loss"):
        if k in aux:
            total = total + aux[k]
    metrics = {"loss": loss, **aux}
    return total, metrics


def _by_layer(layers):
    """The stacked layer tree with each leaf as a list of its L per-layer
    views (no copy)."""
    if isinstance(layers, dict):
        return {k: _by_layer(v) for k, v in layers.items()}
    return list(layers.unbind(0))


def _stack_layers(grads: Dict) -> None:
    """``_by_layer``'s inverse on a gradient tree, in place: each list
    stacked along L and dropped, one leaf at a time (so no more than one
    leaf is held twice)."""
    for k, v in grads.items():
        if isinstance(v, dict):
            _stack_layers(v)
        else:
            grads[k] = torch.stack(v)


def value_and_grad(params, batch, cfg: LMConfig, remat: bool = False):
    """``((total loss, metrics), grads)`` of :func:`loss_fn` (the JAX
    package's ``jax.value_and_grad(loss_fn, has_aux=True)``).  The
    gradients are taken with respect to each layer's views of the stacked
    parameters and stacked once at the end: indexing a stacked leaf that
    requires grad would make every layer's backward write a zero tensor of
    the whole stack and add it (7.2 GB twice a layer at qwen3-4b's
    width)."""
    split = dict(params, layers=_by_layer(params["layers"]))
    out, grads = tree.value_and_grad(lambda p: loss_fn(p, batch, cfg, remat=remat), split)
    _stack_layers(grads["layers"])
    return out, grads


def make_train_step(cfg: LMConfig, optimizer, remat: bool = True):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss's gradients, then ``optimizer.update``, which
    writes into ``params`` and the optimizer state
    (``AdamW.update(inplace=True)``: what fits a full-width model on one
    card) and returns them."""

    def train_step(params, opt_state, batch):
        (loss, metrics), grads = value_and_grad(params, batch, cfg, remat)
        params, opt_state = optimizer.update(params, grads, opt_state, inplace=True)
        metrics["total_loss"] = loss
        return params, opt_state, metrics

    return train_step
