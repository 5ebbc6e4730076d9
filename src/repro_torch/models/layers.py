"""Shared transformer layers (pure functions over parameter dicts).

The JAX package's ``models/layers.py`` on tensors: RMS norms, rotary
embeddings, the chunked online-softmax attention, SwiGLU, the dense and
norm initialisers and the token cross-entropy.  Prefill attention runs as
the hand-written ``flash_attention`` kernel (``models/transformer.py``);
``attention`` here is the chunked twin of the JAX package's, with
``q_offset``, ``kv_len`` and ``window_dynamic``, and serves decode.
Initialisers take an explicit ``torch.Generator`` (JAX's key) and return
parameters only: the logical sharding axes have no counterpart without a
mesh.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype: torch.dtype,
               bias: bool = False, scale: Optional[float] = None):
    """``{"w": (d_in, d_out)[, "b": (d_out,)]}``: w ~ N(0, 1) * scale
    (default 1 / sqrt(d_in)) drawn in float32 on ``gen``'s device, then
    cast to ``dtype``; b zeros."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=gen.device) * scale
    params = {"w": w.to(dtype)}
    if bias:
        params["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return params


def dense_apply(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def norm_init(d: int, dtype: torch.dtype, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rms_norm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dt)


def rms_norm_nd(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm with an explicit scale array (e.g. per-head QK-norm)."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dt)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(d_head: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, d_head); positions: broadcastable to (..., seq)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)           # (d/2,)
    angles = positions[..., :, None].float() * freqs                 # (..., seq, d/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# blocked-softmax attention (the decode path; prefill runs the
# flash_attention kernel)
# ---------------------------------------------------------------------------


NEG_INF = -1e30


def attention(
    q: torch.Tensor,            # (B, S_q, H, D)
    k: torch.Tensor,            # (B, S_kv, KV, D)
    v: torch.Tensor,            # (B, S_kv, KV, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    chunk: int = 1024,
    kv_len: Optional[torch.Tensor] = None,   # (B,) valid KV length (decode)
    window_dynamic: Optional[int] = None,    # scalar overriding window
) -> torch.Tensor:
    """Grouped-query attention with online softmax over KV chunks, in the
    JAX package's arithmetic and order: products and softmax in float32,
    keys padded to whole chunks, each chunk's mask built in its step, masked
    scores -1e30 (so, as there, a row with no valid key averages V over the
    padded chunks rather than giving 0; decode never makes such a row).
    Scores take O(S_q * chunk) memory per step.

    On DTensors whose heads are sharded (a decode step on a mesh), each
    rank runs this on its own batch rows and heads (:func:`_attention_local`)."""
    if _heads_sharded(q):
        return _attention_local(q, k, v, causal=causal, window=window,
                                q_offset=q_offset, chunk=chunk, kv_len=kv_len,
                                window_dynamic=window_dynamic)
    B, Sq, H, D = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    dev = q.device
    qg = q.reshape(B, Sq, KV, G, D).float()
    scale = 1.0 / math.sqrt(D)
    n_chunks = max(1, math.ceil(Skv / chunk))
    q_pos = q_offset + torch.arange(Sq, device=dev)

    m = torch.full((B, Sq, KV, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, KV, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, KV, G, D), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        kc, vc = k[:, sl].float(), v[:, sl].float()
        if kc.shape[1] < chunk:                 # the padded tail, as in JAX
            tail = (0, 0, 0, 0, 0, chunk - kc.shape[1])
            kc, vc = F.pad(kc, tail), F.pad(vc, tail)
        kv_pos = c * chunk + torch.arange(chunk, device=dev)
        s = torch.einsum("bqkgd,bckd->bqkgc", qg, kc) * scale
        if causal:
            mask = kv_pos[None, :] <= q_pos[:, None]
        else:
            mask = torch.ones((Sq, chunk), dtype=torch.bool, device=dev)
        w = window if window_dynamic is None else window_dynamic
        if w is not None:
            mask = mask & (kv_pos[None, :] > q_pos[:, None] - w)
        if kv_len is not None:
            validb = kv_pos[None, :] < kv_len[:, None]          # (B, chunk)
            maskb = mask[None, :, :] & validb[:, None, :]       # (B, Sq, chunk)
        else:
            maskb = (mask & (kv_pos < Skv)[None, :])[None]
        s = torch.where(maskb[:, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqkgc,bckd->bqkgd", p, vc)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, Sq, H, D).to(q.dtype)


def _heads_sharded(q) -> bool:
    """True for a DTensor ``q`` (B, S, H, D) sharded on its head dim."""
    placements = getattr(q, "placements", None)
    return placements is not None and any(
        getattr(p, "dim", None) == 2 for p in placements)


def _attention_local(q, k, v, *, kv_len=None, **kw):
    """:func:`attention` of DTensors, each rank on its own shard.

    The einsums' batch dims are the batch and the KV heads; merged into
    one, a batch sharded over the data axes and heads sharded over
    ``model`` make a strided shard that DTensor's ``bmm`` cannot take.
    Instead ``k`` and ``v`` are laid out as ``q`` is (batch rows over the
    data axes, KV heads over the axis that splits the query heads, which
    ``q``'s constraint keeps to whole KV groups: a cache sharded over its
    sequence moves by one all-to-all), each rank runs the plain attention
    on its rows and heads, and the outputs keep ``q``'s layout."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh, pl = q.device_mesh, q.placements
    rows = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in pl]
    kl = k.redistribute(mesh, pl).to_local()
    vl = v.redistribute(mesh, pl).to_local()
    if kv_len is not None:
        if not isinstance(kv_len, DTensor):
            kv_len = DTensor.from_local(kv_len, mesh, [Replicate()] * len(pl),
                                        run_check=False)
        kv_len = kv_len.redistribute(mesh, rows).to_local()
    out = attention(q.to_local(), kl, vl, kv_len=kv_len, **kw)
    return DTensor.from_local(out, mesh, pl, run_check=False,
                              shape=q.shape, stride=q.stride())


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy in float32 (logits (..., V), labels (...))."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)
