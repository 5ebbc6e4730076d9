"""NequIP (Batzner et al., arXiv:2101.03164) — E(3) tensor-product messages.

Features are (N, C, (l_max+1)^2) real-SH coefficient stacks (C channels per
l).  An interaction layer computes, per edge:

    m^(l3) += w_path(rbf(|r|)) * CG^{l1 l2 l3} ( h_src^(l1) x Y^(l2)(r̂) )

over all allowed paths, aggregates by destination, applies a per-l linear
self-interaction and a gate nonlinearity (scalars: SiLU; l>0 blocks scaled by
a sigmoid gate from dedicated scalar channels).  Readout: per-atom linear on
the scalar block -> per-graph energy sum.

The message sum and the pooled energies are ``scatter_sum`` (the
``segment_spmm`` kernel on the card; the messages as ``(E, C·(l_max+1)²)``
rows), over ``common.message_plans`` built once a forward or passed in
for a fixed batch.  The JAX package's functional updates (``.at[...].add / set /
multiply``) are out-of-place blocks joined by ``torch.cat``, so autograd
sees no in-place write.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import GNNConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.gnn import so3
from repro_torch.models.gnn.common import (bessel_rbf, edge_geometry, gather, message_plans,
                                           mlp_apply, mlp_init, row_local, scatter_sum)


@lru_cache(maxsize=None)
def _paths(l_max: int) -> Tuple[Tuple[int, int, int], ...]:
    out = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(abs(l1 - l2), min(l1 + l2, l_max) + 1):
                if np.abs(so3.clebsch_gordan_real(l1, l2, l3)).max() > 1e-12:
                    out.append((l1, l2, l3))
    return tuple(out)


def init(cfg: GNNConfig, n_species: int, seed: int = 0, device: DeviceLike = None) -> Dict:
    """The JAX package's tree (``embed``, ``layers[i].{radial, lin.l*,
    gate}``, ``readout``) of seeded normal weights on ``device`` (default
    ``"cuda"``)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    C, L = cfg.d_hidden, cfg.l_max
    P = len(_paths(L))

    def normal(shape, fan_in):
        return torch.randn(shape, generator=gen, device=device) / math.sqrt(fan_in)

    params: Dict = {"embed": normal((n_species, C), n_species)}
    layers: List[Dict] = []
    for _ in range(cfg.n_layers):
        layer = {"radial": mlp_init((cfg.n_rbf, 32, P * C), gen, device),
                 "lin": {f"l{l}": normal((C, C), C) for l in range(L + 1)}}
        if L:
            layer["gate"] = normal((C, L * C), C)
        layers.append(layer)
    params["layers"] = layers
    params["readout"] = mlp_init((C, 16, 1), gen, device)
    return params


def _cg(l1: int, l2: int, l3: int, device) -> torch.Tensor:
    return torch.as_tensor(so3.clebsch_gordan_real(l1, l2, l3), device=device).to(torch.float32)


def _messages(radial, h_src, Y, rbf_w, L: int) -> torch.Tensor:
    """Each edge's tensor-product message ``(E, C, (L+1)²)``: each l3 block
    sums its paths' terms in path order, from the first."""
    C = h_src.shape[1]
    paths = _paths(L)
    w = mlp_apply(radial, rbf_w).reshape(-1, len(paths), C)        # (E, P, C)
    blocks: List = [None] * (L + 1)
    for pi, (l1, l2, l3) in enumerate(paths):
        a = h_src[:, :, l1 * l1:(l1 + 1) ** 2]                      # (E, C, 2l1+1)
        b = Y[:, l2 * l2:(l2 + 1) ** 2]                             # (E, 2l2+1)
        out = torch.einsum("ijk,eci,ej->eck", _cg(l1, l2, l3, h_src.device), a, b)
        term = out * w[:, pi, :, None]
        blocks[l3] = term if blocks[l3] is None else blocks[l3] + term
    return torch.cat(blocks, dim=-1)


def _node_update(h, agg, lin, gate, L: int) -> torch.Tensor:
    """Self-interaction per l, the gate nonlinearity and the residual."""
    n, C, _ = h.shape
    mixed = [torch.einsum("cd,ncs->nds", lin[f"l{l}"], agg[:, :, l * l:(l + 1) ** 2])
             for l in range(L + 1)]
    scal = F.silu(mixed[0][:, :, 0])
    out = [scal[:, :, None]]
    if L:
        gates = torch.sigmoid(scal @ gate).reshape(n, L, C)        # (N, L, C)
        out += [mixed[l] * gates[:, l - 1, :, None] for l in range(1, L + 1)]
    return h + torch.cat(out, dim=-1)  # residual


def _interaction(lp, h, Y, rbf_w, src, dst, emask, cfg: GNNConfig, plan=None, nodes=None):
    """One tensor-product message-passing layer; on DTensors the messages
    run on each chip's edges and the update on its nodes (``nodes``: a
    tensor over them, ``h`` when omitted; ``common.row_local``)."""
    n = h.shape[0]
    L = cfg.l_max
    h_src = gather(h, src)                                          # (E, C, S)
    msg = row_local(lambda hs, y, rb, radial: _messages(radial, hs, y, rb, L),
                    dst, h_src, Y, rbf_w, shared=(lp["radial"],))
    agg = scatter_sum(msg, dst, n, emask, plan)
    return row_local(lambda hh, a, lin, gate: _node_update(hh, a, lin, gate, L),
                     h if nodes is None else nodes, h, agg,
                     shared=(lp["lin"], lp.get("gate")))


def forward(params, batch: Dict, cfg: GNNConfig, n_graphs: int,
            plans: Optional[Dict] = None) -> torch.Tensor:
    """Per-graph energy prediction (or per-node when graph_id is absent);
    ``plans`` is the batch's ``common.message_plans`` (built here when
    omitted)."""
    species = batch["node_feat"]                 # (N, n_species) one-hot-ish
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    nmask = batch["node_mask"]
    n = species.shape[0]
    C, L = cfg.d_hidden, cfg.l_max

    h0 = (species @ params["embed"])[:, :, None]
    h = torch.cat([h0, h0.new_zeros((n, C, so3.n_sph(L) - 1))], dim=-1)

    # the edge mask less the edges beyond the cutoff (masked edges too)
    r, dist, emask = edge_geometry(batch, cfg.cutoff)
    Y = so3.sph_harm(r, L)
    rbf = bessel_rbf(dist, cfg.n_rbf, cfg.cutoff)
    if plans is None:
        plans = message_plans(batch, emask, n_graphs)

    for lp in params["layers"]:
        h = _interaction(lp, h, Y, rbf, src, dst, emask, cfg, plans["messages"], nmask)
        h = h * nmask[:, None, None]

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
