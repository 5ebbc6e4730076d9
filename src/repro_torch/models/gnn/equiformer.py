"""EquiformerV2 (Liao et al., arXiv:2306.12059) — equivariant graph
attention with eSCN SO(2) convolutions.

The eSCN trick (Passaro & Zitnick): rotating each edge's SH-coefficient
features into a frame where the edge points at +z makes the tensor-product
convolution block-diagonal in m — an O(L^6) CG contraction becomes O(L^3)
per-m channel mixing.  Per edge:

  1. rotate source features into the edge frame:  x~ = D(R_e) x_src
  2. SO(2) conv for |m| <= m_max (distance-conditioned gates g_m(rbf) and
     learned channel mixes W_m pairing the (+m, -m) coefficient vectors):
        y_{+m} = g (W1 x_{+m} - W2 x_{-m});  y_{-m} = g (W2 x_{+m} + W1 x_{-m})
  3. attention: per-head logits from the rotated scalar (m=0) channel,
     softmax over incoming edges (segment softmax), alpha-weighted messages
  4. rotate back: msg = D(R_e)^T y, aggregate into the destination.

Followed by an equivariant RMS norm and a gated FFN on the scalar block.
m truncation (m_max=2 at l_max=6) is the assigned configuration.

The message sum, the softmax's denominator and the pooled energies are
``scatter_sum`` (the ``segment_spmm`` kernel on the card; at full width
the messages are ``(E, 128 · 49)`` rows), over ``common.message_plans``
built once a forward or passed in for a fixed batch.  The JAX package's functional
updates are out-of-place: the SO(2) output is one ``index_select`` of its
computed columns and a zero column, the FFN's blocks are joined by
``torch.cat``.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import GNNConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.gnn import so3
from repro_torch.models.gnn.common import (bessel_rbf, edge_geometry, gather, message_plans,
                                           mlp_apply, mlp_init, row_local, scatter_sum,
                                           segment_softmax)


def _m_indices(l_max: int, m: int) -> List[int]:
    """Flat SH indices of coefficient m for every l >= |m|."""
    return [so3.sh_index(l, m) for l in range(abs(m), l_max + 1)]


def init(cfg: GNNConfig, n_species: int, seed: int = 0, device: DeviceLike = None) -> Dict:
    """The JAX package's tree (``embed``, ``layers[i].{w0, radial, attn,
    ffn1, ffn2, ffn_gate, out, w{m}_1, w{m}_2}``, ``readout``) of seeded
    normal weights on ``device`` (default ``"cuda"``)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    C, L, M = cfg.d_hidden, cfg.l_max, cfg.m_max

    def normal(shape, fan_in):
        return torch.randn(shape, generator=gen, device=device) / math.sqrt(fan_in)

    params: Dict = {"embed": normal((n_species, C), n_species)}
    layers = []
    for _ in range(cfg.n_layers):
        layer = {
            # per-m channel mixes (W1, W2); m=0 needs only W1
            "w0": normal((C, C), C),
            "radial": mlp_init((cfg.n_rbf, 32, 2 * M + 1), gen, device),
            "attn": mlp_init((C, 32, cfg.n_heads), gen, device),
            "ffn1": normal((C, 2 * C), C),
            "ffn2": normal((2 * C, C), 2 * C),
            "ffn_gate": normal((C, L * C), C),
            "out": normal((C, C), C),
        }
        for m in range(1, M + 1):
            layer[f"w{m}_1"] = normal((C, C), C)
            layer[f"w{m}_2"] = normal((C, C), C)
        layers.append(layer)
    params["layers"] = layers
    params["readout"] = mlp_init((C, 32, 1), gen, device)
    return params


@lru_cache(maxsize=None)
def _so2_layout(l_max: int, m_max: int):
    """``(index lists in the SO(2) conv's order, where each SH index reads
    from the joined columns)``: the columns are m=0's, then +m's and -m's
    for m = 1..m_max, then one zero column for every |m| > m_max."""
    groups = [_m_indices(l_max, 0)]
    for m in range(1, m_max + 1):
        groups += [_m_indices(l_max, m), _m_indices(l_max, -m)]
    flat = [i for g in groups for i in g]
    zero_col = len(flat)
    pos = {s: j for j, s in enumerate(flat)}
    return tuple(map(tuple, groups)), tuple(pos.get(s, zero_col)
                                            for s in range(so3.n_sph(l_max)))


def _so2_conv(lp, x_rot, rbf_gates, cfg: GNNConfig):
    """Blockwise-in-m channel mixing in the edge frame.

    x_rot: (E, C, S); rbf_gates: (E, 2*m_max+1).  Coefficients with |m| >
    m_max are dropped (the eSCN truncation).
    """
    L, M = cfg.l_max, cfg.m_max
    groups, gather_cols = _so2_layout(L, M)
    dev = x_rot.device

    def cols(idx):
        return x_rot.index_select(2, torch.as_tensor(idx, device=dev))

    g0 = rbf_gates[:, M][:, None, None]
    parts = [g0 * torch.einsum("cd,eds->ecs", lp["w0"], cols(groups[0]))]
    for m in range(1, M + 1):
        gp = rbf_gates[:, M + m][:, None, None]
        gm = rbf_gates[:, M - m][:, None, None]
        xp, xm = cols(groups[2 * m - 1]), cols(groups[2 * m])
        W1, W2 = lp[f"w{m}_1"], lp[f"w{m}_2"]
        yp = torch.einsum("cd,eds->ecs", W1, xp) - torch.einsum("cd,eds->ecs", W2, xm)
        ym = torch.einsum("cd,eds->ecs", W2, xp) + torch.einsum("cd,eds->ecs", W1, xm)
        parts += [gp * yp, gm * ym]
    parts.append(x_rot.new_zeros(x_rot.shape[:2] + (1,)))
    return torch.cat(parts, dim=-1).index_select(2, torch.as_tensor(gather_cols, device=dev))


def _equiv_norm(x, l_max: int, eps: float = 1e-6):
    """RMS norm per l-block over (channel, m)."""
    outs = []
    for l in range(l_max + 1):
        lo, hi = l * l, (l + 1) ** 2
        blk = x[:, :, lo:hi]
        rms = torch.sqrt(torch.mean(blk ** 2, dim=(1, 2), keepdim=True) + eps)
        outs.append(blk / rms)
    return torch.cat(outs, dim=-1)


def _edge_logits(lp, x_src, h_dst, rbf, Ds, cfg: GNNConfig):
    """Per edge: the source features rotated into the edge frame, the SO(2)
    conv ``y`` and the attention logits ``(E, H)``."""
    L = cfg.l_max
    x_rot = so3.rotate_coeffs(x_src, Ds, L)            # into edge frame
    gates = mlp_apply(lp["radial"], rbf)               # (E, 2M+1)
    y = _so2_conv(lp, x_rot, gates, cfg)
    # attention logits from the rotated scalar block + destination scalars
    inv = y[:, :, 0] + h_dst
    return y, mlp_apply(lp["attn"], inv)               # (E, H)


def _edge_messages(y, alpha, Ds, cfg: GNNConfig):
    """Heads gate channel groups; the messages rotated back to the global
    frame."""
    y = y * torch.repeat_interleave(alpha, cfg.d_hidden // cfg.n_heads, dim=1)[:, :, None]
    return so3.rotate_coeffs(y, Ds, cfg.l_max, transpose=True)


def _node_update(lp, h, agg, nmask, cfg: GNNConfig):
    """The aggregated messages' channel mix, the residual and the
    equivariant norm, then the gated FFN on the scalar block."""
    n, C, L = h.shape[0], cfg.d_hidden, cfg.l_max
    agg = torch.einsum("cd,nds->ncs", lp["out"], agg)
    h = h + agg
    h = _equiv_norm(h, L) * nmask[:, None, None]
    s = h[:, :, 0]
    f = F.silu(s @ lp["ffn1"]) @ lp["ffn2"]
    gates_l = torch.sigmoid(s @ lp["ffn_gate"]).reshape(n, L, C)
    h = torch.cat([h[:, :, :1] + f[:, :, None]]
                  + [h[:, :, l * l:(l + 1) ** 2] * gates_l[:, l - 1, :, None]
                     for l in range(1, L + 1)], dim=-1)
    return h * nmask[:, None, None]


def forward(params, batch: Dict, cfg: GNNConfig, n_graphs: int,
            plans: Optional[Dict] = None) -> torch.Tensor:
    """Per-graph energies (per-node without graph_id); ``plans`` is the
    batch's ``common.message_plans`` (built here when omitted)."""
    species = batch["node_feat"]
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    nmask = batch["node_mask"]
    n = species.shape[0]
    C, L = cfg.d_hidden, cfg.l_max

    h0 = (species @ params["embed"])[:, :, None]
    h = torch.cat([h0, h0.new_zeros((n, C, so3.n_sph(L) - 1))], dim=-1)

    r, dist, emask = edge_geometry(batch, cfg.cutoff)
    rbf = bessel_rbf(dist, cfg.n_rbf, cfg.cutoff)
    if plans is None:
        plans = message_plans(batch, emask, n_graphs)
    a, b, g = so3.align_to_z_angles(r)
    Ds = so3.rotation_block_diag(a, b, g, L)

    for lp in params["layers"]:
        # -- eSCN attention block: per edge, then a softmax over each
        # destination's edges, then per edge again; on DTensors each chip
        # runs the per-edge and per-node parts on its own rows
        # (``common.row_local``)
        x_src = gather(h, src)
        h_dst = gather(h[:, :, 0], dst)
        y, logits = row_local(
            lambda xs, hd, rb, *D_lp: _edge_logits(D_lp[-1], xs, hd, rb, D_lp[:-1], cfg),
            dst, x_src, h_dst, rbf, *Ds, shared=(lp,))
        alpha = segment_softmax(logits, dst, n, emask, plans["messages"])  # (E, H)
        msg = row_local(lambda yy, al, *D: _edge_messages(yy, al, D, cfg),
                        dst, y, alpha, *Ds)
        agg = scatter_sum(msg, dst, n, emask, plans["messages"])
        h = row_local(lambda hh, a, nm, lay: _node_update(lay, hh, a, nm, cfg),
                      nmask, h, agg, nmask, shared=(lp,))

    atom_e = mlp_apply(params["readout"], h[:, :, 0])[:, 0] * nmask
    gid = batch.get("graph_id")
    if gid is not None:
        return scatter_sum(atom_e, gid, n_graphs, plan=plans["pool"])
    return atom_e


def loss_fn(params, batch: Dict, cfg: GNNConfig, n_graphs: int,
            plans: Optional[Dict] = None):
    pred = forward(params, batch, cfg, n_graphs, plans)
    target = batch["targets"].to(torch.float32)
    loss = torch.mean((pred - target) ** 2)
    return loss, {"loss": loss, "mae": torch.mean(torch.abs(pred - target))}
