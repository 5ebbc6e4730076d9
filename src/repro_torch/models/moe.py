"""Mixture-of-Experts layer, on tensors: top-k routing with sort-based
capacity dispatch.

The JAX package's ``models/moe.py`` (Switch/GShard style): tokens go to
their top-k experts, are laid out into an ``(experts, capacity, d)`` buffer
by a stable sort on expert id (no ``(T, E)`` one-hot), run through
per-expert SwiGLU FFNs (``torch.bmm``, as the JAX package leaves its
grouped einsums to XLA: no kernel), and are combined with their router
weights.  Assignments beyond an expert's capacity are dropped (the token's
residual passes through).

Repeatability on the card:

* top-k breaks ties toward the lower expert id, as ``jax.lax.top_k`` does
  (a stable descending sort; ``torch.topk`` promises no order on CUDA);
* the dispatch sort is stable, as ``jnp.argsort``;
* dispatch writes each kept slot once (an index copy; only the discarded
  drop bin takes several rows), and the combine sums each token's K
  contributions left to right in expert-id order, the order the JAX
  package's scatter-add takes on the CPU, with no atomics.

Three execution paths:

* :func:`apply` — the plain path on one device;
* :func:`apply_mesh` — the JAX package's ``apply_sharded``: expert
  parallelism over a ``DeviceMesh``'s ``model`` axis, on DTensors.  Tokens
  are sharded over the rules' ``batch`` axes and replicated over
  ``model``, expert weights sharded over ``model`` on their first
  dimension; each model shard routes its data row's tokens against the
  whole router, runs its own experts on the assignments that hit them at
  the row's capacity ``C(T_loc)``, and one all-reduce over ``model``
  completes the combine (the JAX package's ``psum``); the router losses
  and the dropped fraction are taken per data row and averaged;
* :func:`apply_sharded` — the same expert parallelism over the ranks of a
  process group (``launch/mesh.py::Transport``): every rank holds all
  tokens and ``E / n_ranks`` experts, capacity counted over all T.

:func:`apply_auto` takes :func:`apply_sharded` when it is given a
transport whose ranks divide the experts, else :func:`apply_mesh` inside
``distributed/sharding.py::activation_sharding`` when the mesh has a
``model`` axis that divides them (as the JAX package's), else
:func:`apply`.

Entry points:
  init(d_model, cfg, dtype, seed, device)       -> params
  route(params, x, cfg)                         -> Routing
  kept(experts, cfg, capacity)                  -> (T, K) bool
  apply(params, x, cfg, capacity)               -> (out, aux)
  apply_mesh(params, x, cfg, mesh, rules, ...)  -> (out, aux)
  apply_sharded(params, x, cfg, transport, ...) -> (out, aux)
  apply_auto(params, x, cfg, transport)         -> (out, aux)
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import _ACT_CTX, mesh_axis_sizes
from repro_torch.models.layers import swiglu


def init(d_model: int, cfg: MoEConfig, dtype: torch.dtype = torch.float32,
         seed: int = 0, device: DeviceLike = None) -> Dict:
    """Random parameters from ``seed`` on ``device`` (default CUDA), with the
    JAX package's shapes and scales: router ``(d, E)``, gate / up
    ``(E, d, F)``, down ``(E, F, d)``, and ``shared`` ``(n_shared, ...)``
    when the configuration has shared experts."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    E, F = cfg.n_experts, cfg.d_expert_ff
    s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(F)

    def nrm(shape, scale):
        t = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return t.mul_(scale).to(dtype)

    params = {"router": {"w": nrm((d_model, E), s_in)},
              "gate": nrm((E, d_model, F), s_in),
              "up": nrm((E, d_model, F), s_in),
              "down": nrm((E, F, d_model), s_out)}
    if cfg.n_shared:
        S = cfg.n_shared
        params["shared"] = {"gate": nrm((S, d_model, F), s_in),
                            "up": nrm((S, d_model, F), s_in),
                            "down": nrm((S, F, d_model), s_out)}
    return params


class Routing(NamedTuple):
    """One token batch's routing: float32 router logits and softmax
    ``(T, E)``, and each token's top-k experts ``(T, K)`` (int64, highest
    probability first, ties to the lower id) with their renormalised
    weights."""

    logits: torch.Tensor
    probs: torch.Tensor
    weights: torch.Tensor
    experts: torch.Tensor


def route(params: Dict, x: torch.Tensor, cfg: MoEConfig) -> Routing:
    """Router logits in ``x.dtype``, then float32 softmax, top-k and
    renormalisation with a 1e-9 floor."""
    logits = (x @ params["router"]["w"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :cfg.top_k], top_e[:, :cfg.top_k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return Routing(logits, probs, top_p, top_e)


def capacity_of(T: int, cfg: MoEConfig, capacity: Optional[int] = None) -> int:
    """Slots per expert: ``capacity`` or ``max(1, ceil(T·K/E·factor))``."""
    return capacity or max(
        1, int(math.ceil(T * cfg.top_k / cfg.n_experts * cfg.capacity_factor)))


def _dispatch(eid: torch.Tensor, n_exp: int, C: int):
    """The sort-based dispatch of ``T·K`` assignments to experts ``eid``
    (T, K) in ``[0, n_exp]`` (``n_exp``: an expert held elsewhere): the
    stable order by expert, whether each sorted assignment is kept (its rank
    within its expert below C), and its slot (``n_exp·C``, the drop bin, if
    not)."""
    flat = eid.reshape(-1)
    order = torch.argsort(flat, stable=True)
    s = flat[order]
    starts = torch.searchsorted(s, torch.arange(n_exp, device=eid.device))
    rank = torch.arange(flat.shape[0], device=eid.device) - starts[s.clamp_max(n_exp - 1)]
    keep = (s < n_exp) & (rank < C)
    return order, keep, torch.where(keep, s * C + rank, n_exp * C)


def kept(experts: torch.Tensor, cfg: MoEConfig,
         capacity: Optional[int] = None) -> torch.Tensor:
    """Which of the (T, K) assignments ``experts`` (a :class:`Routing`'s) get
    a slot at :func:`apply`'s capacity: (T, K) bool."""
    T, K = experts.shape
    order, keep, _ = _dispatch(experts, cfg.n_experts, capacity_of(T, cfg, capacity))
    out = torch.empty_like(keep)
    out[order] = keep
    return out.view(T, K)


def _experts(x: torch.Tensor, eid: torch.Tensor, w: torch.Tensor,
             n_exp: int, C: int, gate: torch.Tensor, up: torch.Tensor,
             down: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch, expert SwiGLU and combine for the ``T·K`` assignments of
    ``x`` (T, d) to local experts ``eid`` (T, K) (:func:`_dispatch`) with
    weights ``w`` (T, K).  Returns the ``(T, d)`` output and the kept mask
    of the sorted assignments."""
    T, d = x.shape
    K = eid.shape[1]
    dev = x.device
    order, keep, slot = _dispatch(eid, n_exp, C)
    token_of = order // K

    # each kept slot is written once; several rows land only in the
    # drop bin, which is cut off
    buf = x.new_zeros((n_exp * C + 1, d))
    buf.index_copy_(0, slot, x[token_of])
    buf = buf[:n_exp * C].view(n_exp, C, d)
    h = torch.bmm(buf, gate.to(x.dtype))
    u = torch.bmm(buf, up.to(x.dtype))
    y = torch.bmm(swiglu(h, u), down.to(x.dtype)).view(n_exp * C, d)
    del buf, h, u

    # combine: each token's K contributions summed left to right in the
    # sorted (expert-id) order
    w_sorted = w.reshape(-1)[order].to(x.dtype)
    pos = torch.empty_like(order)
    pos[order] = torch.arange(T * K, device=dev)
    pos = pos.view(T, K).sort(dim=1).values
    out = None
    for j in range(K):
        p = pos[:, j]
        part = torch.where(keep[p, None], y[slot[p].clamp_max(n_exp * C - 1)],
                           0.0) * w_sorted[p, None]
        out = part if out is None else out + part
    return out, keep


def _shared(params: Dict, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    sp = params.get("shared")
    if sp is not None:
        for i in range(sp["gate"].shape[0]):
            out = out + swiglu(x @ sp["gate"][i].to(x.dtype),
                               x @ sp["up"][i].to(x.dtype)) @ sp["down"][i].to(x.dtype)
    return out


def _router_losses(r: Routing, cfg: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Switch's load-balance loss and the router z-loss (float32 scalars)."""
    T, K = r.experts.shape
    E = cfg.n_experts
    me = r.probs.mean(dim=0)
    # each expert's share of the assignments: an integer count whose shape
    # follows from E (a bincount's would follow from the data)
    ids = r.experts.reshape(-1).long()
    counts = torch.zeros(E, dtype=torch.int64, device=ids.device).index_add(
        0, ids, torch.ones_like(ids))
    ce = counts.float() / (T * K)
    aux = cfg.aux_coef * E * torch.sum(me * ce)
    z = cfg.router_z_coef * torch.mean(torch.logsumexp(r.logits, dim=-1) ** 2)
    return aux, z


def apply(params: Dict, x: torch.Tensor, cfg: MoEConfig,
          capacity: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
    """x: (T, d) token-major.  Returns (out (T, d), aux), aux holding the
    float32 scalars ``moe_aux_loss``, ``moe_z_loss``, ``moe_dropped_frac``."""
    T = x.shape[0]
    r = route(params, x, cfg)
    out, keep = _experts(x, r.experts, r.weights, cfg.n_experts,
                         capacity_of(T, cfg, capacity), params["gate"],
                         params["up"], params["down"])
    out = _shared(params, x, out)
    aux, z = _router_losses(r, cfg)
    return out, {"moe_aux_loss": aux, "moe_z_loss": z,
                 "moe_dropped_frac": 1.0 - keep.float().mean()}


def apply_sharded(params: Dict, x: torch.Tensor, cfg: MoEConfig, transport,
                  capacity: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
    """Expert-parallel :func:`apply` over ``transport``'s ranks (module doc).

    ``x`` (T, d) is the same on every rank.  ``params``' expert weights hold
    either all E experts (each rank takes its own ``E / n_ranks``) or the
    rank's own, experts ``[rank·E/n, (rank+1)·E/n)``; the router and the
    shared experts are whole on every rank.  Capacity is counted over all
    T tokens, so each expert keeps what it keeps in :func:`apply`."""
    T = x.shape[0]
    E, n, me = cfg.n_experts, transport.size, transport.rank
    if E % n:
        raise ValueError(f"{E} experts do not divide over {n} ranks")
    E_loc = E // n
    held = params["gate"].shape[0]
    if held == E:
        lo = me * E_loc
        gate, up, down = (params[k][lo:lo + E_loc] for k in ("gate", "up", "down"))
    elif held == E_loc:
        gate, up, down = params["gate"], params["up"], params["down"]
    else:
        raise ValueError(f"rank {me} holds {held} experts: expected {E} or {E_loc}")
    r = route(params, x, cfg)
    local = r.experts - me * E_loc
    local = torch.where((local >= 0) & (local < E_loc), local, E_loc)
    partial, keep = _experts(x, local, r.weights, E_loc,
                             capacity_of(T, cfg, capacity), gate, up, down)
    out = transport.all_reduce(partial, key="moe_out")
    kept = transport.all_reduce(keep.sum().float().reshape(1), key="moe_kept")
    out = _shared(params, x, out)
    aux, z = _router_losses(r, cfg)
    return out, {"moe_aux_loss": aux, "moe_z_loss": z,
                 "moe_dropped_frac": 1.0 - kept[0] / (T * cfg.top_k)}


def _mesh_locals(mesh, rules, x: torch.Tensor):
    """``(batch_axes, layouts)`` of the mesh route: ``batch_axes`` the
    rules' ``batch`` axes that divide ``x``'s rows (the divisibility
    fallback of ``constrain``); ``layouts`` the placements of ``x``, the
    experts and the router (each with its gradient's), of the partial
    outputs and of the rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    batch = rules.spec(("batch", None), shape=tuple(x.shape), mesh=mesh)
    batch_axes = () if not batch or batch[0] is None else (
        (batch[0],) if isinstance(batch[0], str) else tuple(batch[0]))
    names = list(mesh_axis_sizes(mesh))

    def pl(shard_batch, shard_model, partial_rest):
        out = []
        for a in names:
            if a in batch_axes and shard_batch is not None:
                out.append(shard_batch)
            elif a == "model" and shard_model is not None:
                out.append(shard_model)
            else:
                out.append(Partial() if partial_rest else Replicate())
        return out

    return batch_axes, dict(
        # forward layouts, then the layouts of their gradients: what a
        # rank computes from its own rows or experts is a partial sum
        # along the mesh dims it is replicated over
        x=(pl(Shard(0), None, False), pl(Shard(0), Partial(), False)),
        experts=(pl(None, Shard(0), False), pl(Partial(), Shard(0), True)),
        router=(pl(None, None, False), pl(None, None, True)),
        partial=pl(Shard(0), Partial(), False),
        rows=pl(Shard(0), None, False))


class _GradScale(torch.autograd.Function):
    """The identity forward; the gradient times ``scale`` backward."""

    @staticmethod
    def forward(ctx, t, scale):
        ctx.scale = scale
        return t.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


def apply_mesh(params: Dict, x: torch.Tensor, cfg: MoEConfig, mesh, rules,
               capacity: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
    """Expert-parallel :func:`apply` over ``mesh``'s ``model`` axis (module
    doc), the JAX package's ``apply_sharded(params, x, cfg, mesh, rules)``.

    ``x`` (T, d) and the weights are DTensors on ``mesh`` (redistributed to
    the route's layouts) or tensors, each rank's copy of the whole (the
    output is then gathered whole).
    Capacity is ``max(1, ceil(T_loc·K/E·capacity_factor))`` for a data
    row's ``T_loc`` tokens.  The output keeps ``x``'s rows sharded over the
    batch axes; the three aux scalars are the data rows' mean."""
    from torch.distributed.tensor import DTensor, Replicate

    sizes = mesh_axis_sizes(mesh)
    E, K = cfg.n_experts, cfg.top_k
    n_model = sizes["model"]
    if E % n_model:
        raise ValueError(f"{E} experts do not divide over {n_model} model shards")
    E_loc = E // n_model
    batch_axes, pl = _mesh_locals(mesh, rules, x)
    n_batch = math.prod(sizes[a] for a in batch_axes)
    T = x.shape[0]
    T_loc = T // n_batch
    C = capacity_of(T_loc, cfg, capacity)
    plain_in = not isinstance(x, DTensor)

    rep = [Replicate()] * len(sizes)

    def local(t, layout):
        fwd, grad = layout
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, rep, run_check=False)
        return t.redistribute(mesh, fwd).to_local(grad_placements=grad)

    xl = local(x, pl["x"])
    gate, up, down = (local(params[k], pl["experts"]) for k in ("gate", "up", "down"))
    router = {"router": {"w": local(params["router"]["w"], pl["router"])}}
    me = mesh.get_local_rank("model")

    r = route(router, xl, cfg)
    lid = r.experts - me * E_loc
    lid = torch.where((lid >= 0) & (lid < E_loc), lid, E_loc)
    partial, keep = _experts(xl, lid, r.weights, E_loc, C, gate, up, down)
    aux, z = _router_losses(r, cfg)

    # the combine: one all-reduce over model
    out = DTensor.from_local(partial, mesh, pl["partial"], run_check=False,
                             shape=(T, partial.shape[1]),
                             stride=(partial.shape[1], 1))
    out = out.redistribute(mesh, pl["rows"])
    # per data row: its aux and z, its kept count summed over model.  The
    # losses are the same on every model shard of a row, and each shard
    # gets their whole gradient; the router's and x's gradients are summed
    # over model, so each shard passes back 1 / n_model of it (the JAX
    # package's shard_map divides an unmapped output's cotangent alike)
    losses = _GradScale.apply(torch.stack([aux, z]), 1.0 / n_model)
    rows = DTensor.from_local(losses[None], mesh, pl["rows"],
                              run_check=False, shape=(n_batch, 2), stride=(2, 1))
    kept = DTensor.from_local(keep.sum().float().reshape(1), mesh, pl["partial"],
                              run_check=False, shape=(n_batch,), stride=(1,))
    mean = rows.mean(dim=0).redistribute(mesh, rep)
    dropped = (1.0 - kept.redistribute(mesh, pl["rows"]) / (T_loc * K)).mean()
    dropped = dropped.redistribute(mesh, rep)
    if plain_in:
        out = out.full_tensor()
        mean, dropped = mean.full_tensor(), dropped.full_tensor()
    sp = params.get("shared")
    if sp is not None and not plain_in:
        # weights given whole on every chip, beside DTensor tokens
        sp = {k: w if isinstance(w, DTensor) else DTensor.from_local(w, mesh, rep, run_check=False)
              for k, w in sp.items()}
    out = _shared({"shared": sp}, x, out)
    return out, {"moe_aux_loss": mean[0], "moe_z_loss": mean[1],
                 "moe_dropped_frac": dropped}


def apply_auto(params: Dict, x: torch.Tensor, cfg: MoEConfig,
               transport=None) -> Tuple[torch.Tensor, Dict]:
    """:func:`apply_sharded` over ``transport`` when one is given and the
    experts divide over its ranks; else :func:`apply_mesh` when an
    ``activation_sharding`` mesh with a ``model`` axis that divides the
    experts is active; else :func:`apply`."""
    if transport is not None:
        if cfg.n_experts % transport.size == 0:
            return apply_sharded(params, x, cfg, transport)
        return apply(params, x, cfg)
    ctx = _ACT_CTX.get()
    if ctx is not None:
        mesh, rules = ctx
        sizes = mesh_axis_sizes(mesh)
        if ("model" in sizes and cfg.n_experts % sizes["model"] == 0
                and hasattr(mesh, "mesh_dim_names")):
            return apply_mesh(params, x, cfg, mesh, rules)
    return apply(params, x, cfg)
