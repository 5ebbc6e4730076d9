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
    """Mean token cross-entropy in float32 (logits (..., V), labels (...)).
    DTensor logits take :class:`_ShardedCrossEntropy`, each rank on its own
    rows and slice of the vocabulary."""
    if getattr(logits, "placements", None) is not None:
        return _ShardedCrossEntropy.apply(logits, labels)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


# ---------------------------------------------------------------------------
# DTensor routes of the vocabulary's two ends: each rank on its own rows and
# its slice of the vocabulary, as GSPMD keeps them in the JAX package
# ---------------------------------------------------------------------------


def _contiguous_stride(shape):
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _on_mesh(t, mesh, placements, shape):
    """The DTensor of this rank's ``t`` (contiguous) with ``placements``."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t, mesh, placements, run_check=False, shape=tuple(shape),
                              stride=_contiguous_stride(shape))


def _reduced(t, mesh, layout, dims, op, shape):
    """This rank's ``t``, one part of a sum (or max, ``op``) over the mesh
    dims ``dims``, reduced there: the local tensor of the result laid out
    as ``layout`` (of global ``shape``)."""
    if not dims:
        return t
    from torch.distributed.tensor import Partial

    parts = [Partial(op) if i in dims else p for i, p in enumerate(layout)]
    return _on_mesh(t, mesh, parts, shape).redistribute(mesh, layout).to_local()


def _slice_offset(shape, mesh, placements, dim):
    """Where this rank's slice of tensor dim ``dim`` starts: the mesh dims
    that split it do so in turn, major first, in ``torch.chunk``'s pieces."""
    coord = mesh.get_coordinate()
    size, start = shape[dim], 0
    for i, p in enumerate(placements):
        if p.is_shard(dim):
            chunk = -(-size // mesh.size(i))
            lo = min(coord[i] * chunk, size)
            size, start = min(size - lo, chunk), start + lo
    return start


def _rows_of(t, mesh, layout):
    """This rank's part of ``t`` (a DTensor, or a tensor every rank holds
    whole) laid out as ``layout``."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return t.redistribute(mesh, layout).to_local()


class _ShardedCrossEntropy(torch.autograd.Function):
    """:func:`cross_entropy` of DTensor logits (..., V) laid out by shards of
    their rows and of V (as the LM head lays them out), each rank on its own: the log-sum-exp from a local
    max and sum reduced over the mesh dims that split V, the gold logit
    read from the rank's own slice (at the label less the slice's offset, 0
    where the label lies in another slice) and summed over those dims (one
    term and zeros: exact), the mean over the rows' mesh dims.  The
    gradient is the local softmax less the local one-hot, times the loss's
    gradient over the token count, on the local shard: no tensor of the
    global batch's logits and none of the whole vocabulary is made."""

    @staticmethod
    def forward(ctx, logits, labels):
        from torch.distributed.tensor import Replicate

        mesh, pl, vd = logits.device_mesh, tuple(logits.placements), logits.ndim - 1
        vocab = [i for i, p in enumerate(pl) if p.is_shard(vd)]
        rows = [Replicate() if i in vocab else p for i, p in enumerate(pl)]
        rshape = tuple(logits.shape[:-1])
        x = logits.to_local()
        xf = x.float()
        lab = _rows_of(labels, mesh, rows).long()
        m = _reduced(xf.amax(-1), mesh, rows, vocab, "max", rshape)
        s = _reduced((xf - m[..., None]).exp_().sum(-1), mesh, rows, vocab, "sum", rshape)
        logz = m + torch.log(s)
        idx = lab - _slice_offset(logits.shape, mesh, pl, vd)
        inside = (idx >= 0) & (idx < x.shape[-1])
        idx = torch.where(inside, idx, 0)
        gold = torch.where(inside, torch.gather(xf, -1, idx[..., None])[..., 0], 0.0)
        gold = _reduced(gold, mesh, rows, vocab, "sum", rshape)
        n = math.prod(rshape)
        whole = [Replicate()] * mesh.ndim
        batch = [i for i, p in enumerate(rows) if p.is_shard()]
        loss = _reduced((logz - gold).sum(), mesh, whole, batch, "sum", ()) / n
        ctx.save_for_backward(x, logz, idx, inside)
        ctx.layout = (mesh, pl, logits.shape, n)
        return _on_mesh(loss, mesh, whole, ())

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate

        mesh, pl, shape, n = ctx.layout
        x, logz, idx, inside = ctx.saved_tensors
        g = _rows_of(g, mesh, [Replicate()] * mesh.ndim)
        p = x.to(torch.float32, copy=True)
        p.sub_(logz[..., None]).exp_()
        p.scatter_add_(-1, idx[..., None], -inside.to(p.dtype)[..., None])
        p.mul_(g / n)
        return _on_mesh(p.to(x.dtype), mesh, pl, shape), None


class _EmbedRows(torch.autograd.Function):
    """``table[tokens]`` of a DTensor table (V, d) split over V (and d), on
    each rank's rows of ``tokens``: the table gathered over d (still split
    over V), each row looked up in the rank's own slice (0 where its token
    lies in another slice), and summed over the mesh dims that split V (one
    term and zeros: exact).  The output is laid out as ``tokens`` (their
    row shards; replicated over the mesh dims that split V).  The table's
    gradient: each rank's rows added into its slice, summed over the mesh
    dims that split the rows and laid out as the table.  No tensor of the
    global batch's rows is made."""

    @staticmethod
    def forward(ctx, table, tokens):
        from torch.distributed.tensor import DTensor, Replicate, Shard

        mesh, tpl = table.device_mesh, tuple(table.placements)
        vocab = [i for i, p in enumerate(tpl) if p.is_shard(0)]
        sliced = [Shard(0) if i in vocab else Replicate() for i in range(mesh.ndim)]
        tok_pl = ([Replicate()] * mesh.ndim if not isinstance(tokens, DTensor) else
                  [Replicate() if i in vocab else p for i, p in enumerate(tokens.placements)])
        tok = _rows_of(tokens, mesh, tok_pl).long()
        local = table.redistribute(mesh, sliced).to_local()
        idx = tok - _slice_offset(table.shape, mesh, sliced, 0)
        inside = (idx >= 0) & (idx < local.shape[0])
        idx = torch.where(inside, idx, 0)
        shape = tuple(tokens.shape) + (table.shape[1],)
        out = torch.where(inside[..., None], local[idx], 0.0)
        out = _reduced(out, mesh, tok_pl, vocab, "sum", shape)
        ctx.save_for_backward(idx, inside)
        ctx.layout = (mesh, tpl, sliced, tok_pl, table.shape, tuple(local.shape))
        return _on_mesh(out, mesh, tok_pl, shape)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Partial

        mesh, tpl, sliced, tok_pl, shape, local_shape = ctx.layout
        idx, inside = ctx.saved_tensors
        g = _rows_of(g, mesh, tok_pl)
        d = g.shape[-1]
        grad = torch.zeros(local_shape, dtype=g.dtype, device=g.device)
        grad.index_add_(0, idx.reshape(-1),
                        torch.where(inside[..., None], g, 0.0).reshape(-1, d))
        parts = [Partial() if q.is_shard() else p for p, q in zip(sliced, tok_pl)]
        return _on_mesh(grad, mesh, parts, shape).redistribute(mesh, tpl), None


def embed_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``; a DTensor table takes :class:`_EmbedRows`, each
    rank on its own rows of ``tokens`` and its slice of the vocabulary."""
    if getattr(table, "placements", None) is not None:
        return _EmbedRows.apply(table, tokens)
    return table[tokens.long()]
