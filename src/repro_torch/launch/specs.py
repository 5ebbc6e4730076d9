"""Per-cell (architecture x input-shape) build plans for the dry-run.

The JAX package's ``launch/specs.py``: ``build_cell(arch, shape, mesh)``
returns the step function, its arguments as shapes without allocation
(tensors on the ``meta`` device, the counterpart of
``jax.ShapeDtypeStruct``), and in / out shardings resolved from logical
axis rules (``distributed/sharding.py``'s ``NamedSharding``: a spec and its
DTensor placements).  There is no ``jax.jit``: :meth:`CellPlan.lower` runs
the step once on fake tensors and counts one device's work
(``launch/hlo_analysis.py``), and on the card the same ``step_fn`` runs on
real tensors.

``mesh`` is a ``DeviceMesh`` with named dims (``launch/mesh.py``) or
anything with a ``shape`` dict of axis sizes (:func:`axis_mesh`), which is
all that a plan's specs read.

Where the port's step departs from the JAX package's:

* the decode cells' cache carries ``pos`` as an int32 scalar, as the
  JAX package's does; the step decodes at position ``seq_len - 1`` (the
  last slot: one new token against a full cache), because a fake run
  cannot read a position off the device;
* the TAPER cell's step is :func:`repro_torch.core.visitor.field_from_arrays`
  with the ``cuda`` backend (``vm_step``); on a mesh of several chips its
  arguments are gathered whole first (the field reads every edge), each
  chip runs the whole step, and each keeps its slice of the outputs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import DLRMConfig, GNNConfig, LMConfig, ShapeSpec, TaperSystemConfig
from repro_torch.configs.registry import get_config, shapes_for
from repro_torch.core.tpstry import synthetic_trie
from repro_torch.core.visitor import field_from_arrays
from repro_torch.distributed.sharding import (LogicalAxisRules, NamedSharding,
                                              logical_to_sharding, placements_for,
                                              rules_for, tree_shardings)
from repro_torch.models import dlrm as dlrm_lib
from repro_torch.models import transformer as tf
from repro_torch.models.gnn import api as gnn_api
from repro_torch.optim import AdamW
from repro_torch.utils import tree

F32, BF16, I32, BOOL = torch.float32, torch.bfloat16, torch.int32, torch.bool
_NP_DTYPES = {"float32": F32, "int32": I32}


def sds(shape, dtype) -> torch.Tensor:
    """A shape and a type, allocated nowhere: a ``meta`` tensor."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


@dataclass(frozen=True)
class AxisMesh:
    """Named axis sizes with no devices behind them: a mesh for plans whose
    specs are all that is wanted (and for a one-chip fake run)."""

    shape: Dict[str, int]


def axis_mesh(**sizes: int) -> AxisMesh:
    return AxisMesh(dict(sizes))


@dataclass
class CellPlan:
    arch: str
    shape: ShapeSpec
    step_name: str
    step_fn: Callable
    args: Tuple[Any, ...]              # trees of meta tensors
    in_shardings: Tuple[Any, ...]
    out_shardings: Any
    meta: Dict[str, Any] = field(default_factory=dict)
    mesh: Any = None
    rules: Any = None
    constrain_activations: bool = True

    def lower(self):
        """Run the step once on fake arguments laid out by the input
        shardings and count one device's work: a
        :class:`repro_torch.launch.hlo_analysis.FakeRun`."""
        from repro_torch.distributed.sharding import activation_sharding
        from repro_torch.launch.hlo_analysis import run_fake

        if self.constrain_activations and _devices(self.mesh):
            with activation_sharding(self.mesh, self.rules):
                return run_fake(self)
        return run_fake(self)


def _devices(mesh) -> bool:
    return hasattr(mesh, "mesh_dim_names")


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(tuple(t.shape), dtype=t.dtype, device="meta")


def shape_init(init_fn, logical_fn, *args):
    """``(shapes, logical)``: ``init_fn(*args, device="cpu")`` run under a
    fake-tensor mode (nothing allocated, not even at a trillion
    parameters), its leaves as meta tensors, and the logical axes that
    ``logical_fn`` gives for them."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = init_fn(*args, device="cpu")
    shapes = tree.map_leaves(_meta, params)
    return shapes, logical_fn(shapes)


def _shard_tree(mesh, rules, logical_tree, shapes_tree=None):
    return tree_shardings(mesh, logical_tree, shapes_tree, rules)


def _named(mesh, rules, *axes, shape=None) -> NamedSharding:
    return logical_to_sharding(mesh, axes, rules, shape)


def _replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, (), placements_for(mesh, ()))


def _opt_shapes(opt: AdamW, params_shapes):
    return opt.init(params_shapes)          # zeros_like of meta tensors: meta


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------


def _lm_cell(cfg: LMConfig, shape: ShapeSpec, mesh, rules,
             optimizer: Optional[AdamW] = None, remat: bool = True) -> CellPlan:
    B = shape.dim("global_batch")
    S = shape.dim("seq_len")
    params_shapes, logical = shape_init(tf.init, lambda _: tf.param_logical_axes(cfg), cfg)
    p_shard = _shard_tree(mesh, rules, logical, params_shapes)
    n_active = cfg.n_active_params()
    cache_dt = BF16 if cfg.dtype == "bfloat16" else F32

    if shape.kind == "train":
        opt = optimizer or AdamW(learning_rate=3e-4)
        opt_shapes = _opt_shapes(opt, params_shapes)
        opt_shard = _shard_tree(mesh, rules, opt.state_logical_axes(logical), opt_shapes)
        batch = {
            "tokens": sds((B, S), I32),
            "labels": sds((B, S), I32),
        }
        b_shard = {
            "tokens": _named(mesh, rules, "batch", None, shape=(B, S)),
            "labels": _named(mesh, rules, "batch", None, shape=(B, S)),
        }
        step = tf.make_train_step(cfg, opt, remat=remat)
        model_flops = 6.0 * n_active * B * S \
            + 12.0 * cfg.n_layers * cfg.n_heads * cfg.d_head * B * S * S / 2
        return CellPlan(
            cfg.name, shape, "train_step", step,
            (params_shapes, opt_shapes, batch),
            (p_shard, opt_shard, b_shard),
            (p_shard, opt_shard, None),
            {"model_flops": model_flops, "n_params": cfg.n_params(),
             "n_active": n_active, "tokens": B * S},
        )

    if shape.kind == "prefill":
        def prefill(params, tokens):
            logits, aux, cache = tf.forward(params, tokens, cfg, return_cache=True)
            return logits[:, -1, :], cache

        tokens = sds((B, S), I32)
        t_shard = _named(mesh, rules, "batch", None, shape=(B, S))
        cache_shapes = {
            "k": sds((cfg.n_layers, B, S, cfg.n_kv_heads, cfg.d_head), cache_dt),
            "v": sds((cfg.n_layers, B, S, cfg.n_kv_heads, cfg.d_head), cache_dt),
            "pos": sds((), I32),
        }
        cache_shard = _shard_tree(mesh, rules, tf.cache_logical_axes(cfg),
                                  cache_shapes)
        out_shard = (_named(mesh, rules, "batch", "vocab"), cache_shard)
        model_flops = 2.0 * n_active * B * S \
            + 4.0 * cfg.n_layers * cfg.n_heads * cfg.d_head * B * S * S / 2
        return CellPlan(
            cfg.name, shape, "prefill_step", prefill,
            (params_shapes, tokens), (p_shard, t_shard), out_shard,
            {"model_flops": model_flops, "n_params": cfg.n_params(),
             "n_active": n_active, "tokens": B * S},
        )

    # decode cells: one new token against a seq_len KV cache
    long_ctx = S >= 262144
    cache_logical = tf.cache_logical_axes(cfg, long_context=long_ctx)
    cache = {
        "k": sds((cfg.n_layers, B, S, cfg.n_kv_heads, cfg.d_head), cache_dt),
        "v": sds((cfg.n_layers, B, S, cfg.n_kv_heads, cfg.d_head), cache_dt),
        "pos": sds((), I32),
    }
    cache_shard = _shard_tree(mesh, rules, cache_logical, cache)
    tokens = sds((B, 1), I32)
    t_shard = _named(mesh, rules, None if long_ctx else "batch", None, shape=(B, 1))

    def decode(params, cache, tokens):
        # the last slot: a fake run cannot read ``pos`` off the device
        return tf.decode_step(params, dict(cache, pos=S - 1), tokens, cfg)

    # decode flops: params once per token + attention against the cache
    model_flops = 2.0 * n_active * B \
        + 4.0 * cfg.n_layers * cfg.n_heads * cfg.d_head * B * S
    kv_bytes = 2 * cfg.n_layers * B * S * cfg.n_kv_heads * cfg.d_head * 2
    return CellPlan(
        cfg.name, shape, "serve_step", decode,
        (params_shapes, cache, tokens),
        (p_shard, cache_shard, t_shard),
        ((_named(mesh, rules, None if long_ctx else "batch", None, "vocab"),
          cache_shard)),
        {"model_flops": model_flops, "n_params": cfg.n_params(),
         "n_active": n_active, "tokens": B, "kv_bytes": kv_bytes},
    )


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------


def _gnn_batch_specs(cfg: GNNConfig, shape: ShapeSpec, mesh, rules):
    d_feat = gnn_api.feature_dim(cfg, shape)
    if shape.name == "molecule":
        G = shape.dim("batch")
        N = G * shape.dim("n_nodes")
        E = G * shape.dim("n_edges")
    elif shape.name == "minibatch_lg":
        seeds = shape.dim("batch_nodes")
        f1, f2 = shape.dim("fanout1"), shape.dim("fanout2")
        N = seeds * (1 + f1 + f1 * f2)
        E = seeds * f1 + seeds * f1 * f2
    else:
        N = shape.dim("n_nodes")
        E = shape.dim("n_edges")
    batch = {
        "node_feat": sds((N, d_feat), F32),
        "edge_src": sds((E,), I32),
        "edge_dst": sds((E,), I32),
        "node_mask": sds((N,), BOOL),
        "edge_mask": sds((E,), BOOL),
    }
    shard = {
        "node_feat": _named(mesh, rules, "nodes", None, shape=(N, d_feat)),
        "edge_src": _named(mesh, rules, "edges", shape=(E,)),
        "edge_dst": _named(mesh, rules, "edges", shape=(E,)),
        "node_mask": _named(mesh, rules, "nodes", shape=(N,)),
        "edge_mask": _named(mesh, rules, "edges", shape=(E,)),
    }
    if gnn_api.needs_positions(cfg):
        batch["positions"] = sds((N, 3), F32)
        shard["positions"] = _named(mesh, rules, "nodes", None, shape=(N, 3))
    if shape.name == "molecule":
        batch["graph_id"] = sds((N,), I32)
        shard["graph_id"] = _named(mesh, rules, "nodes", shape=(N,))
    tshape, tdtype = gnn_api.target_spec(cfg, shape, N)
    batch["targets"] = sds(tshape, _NP_DTYPES[tdtype.__name__])
    shard["targets"] = _named(
        mesh, rules, "nodes" if tshape == (N,) else None, shape=tshape)
    return batch, shard, N, E, d_feat


def _gnn_model_flops(cfg: GNNConfig, N: int, E: int, d_feat: int) -> float:
    C, L = cfg.d_hidden, cfg.n_layers
    if cfg.kind == "gcn":
        dims = [d_feat] + [C] * (L - 1) + [cfg.n_classes]
        return sum(2.0 * N * a * b + 2.0 * E * a for a, b in zip(dims, dims[1:]))
    if cfg.kind == "gin":
        per = 2.0 * E * C + 2.0 * N * (C * C * 2)
        return L * per + 2.0 * N * d_feat * C
    S = (cfg.l_max + 1) ** 2
    if cfg.kind == "nequip":
        paths = (cfg.l_max + 1) ** 3  # upper bound on CG paths
        per = 2.0 * E * C * S * (2 * cfg.l_max + 1) * paths / (cfg.l_max + 1) \
            + 2.0 * N * C * C * S
        return L * per
    # equiformer_v2 (eSCN): rotation (S^1.5-ish) + per-m channel mixes
    wigner = sum((2 * l + 1) ** 2 for l in range(cfg.l_max + 1))
    per = 2.0 * E * C * wigner * 2 \
        + 2.0 * E * C * C * (2 * cfg.m_max + 1) \
        + 2.0 * N * C * C * 2
    return L * per


def _gnn_cell(cfg: GNNConfig, shape: ShapeSpec, mesh, rules,
              optimizer: Optional[AdamW] = None) -> CellPlan:
    batch, b_shard, N, E, d_feat = _gnn_batch_specs(cfg, shape, mesh, rules)
    params_shapes, logical = shape_init(
        gnn_api.init, lambda p: gnn_api.param_logical_axes(cfg, p), cfg, shape)
    p_shard = _shard_tree(mesh, rules, logical, params_shapes)
    opt = optimizer or AdamW(learning_rate=1e-3, weight_decay=0.0)
    opt_shapes = _opt_shapes(opt, params_shapes)
    opt_shard = _shard_tree(mesh, rules, opt.state_logical_axes(logical), opt_shapes)
    step = gnn_api.make_train_step(cfg, shape, opt)
    n_params = sum(t.numel() for t in tree.leaves(params_shapes))
    return CellPlan(
        cfg.name, shape, "train_step", step,
        (params_shapes, opt_shapes, batch),
        (p_shard, opt_shard, b_shard),
        (p_shard, opt_shard, None),
        {"model_flops": _gnn_model_flops(cfg, N, E, d_feat),
         "n_params": n_params, "nodes": N, "edges": E},
    )


# ---------------------------------------------------------------------------
# DLRM cells
# ---------------------------------------------------------------------------


def _dlrm_cell(cfg: DLRMConfig, shape: ShapeSpec, mesh, rules,
               optimizer: Optional[AdamW] = None) -> CellPlan:
    params_shapes, logical = shape_init(
        dlrm_lib.init, lambda _: dlrm_lib.param_logical_axes(cfg), cfg)
    p_shard = _shard_tree(mesh, rules, logical, params_shapes)
    mlp_flops = 0.0
    dims = (cfg.n_dense,) + cfg.bot_mlp
    mlp_flops += sum(2.0 * a * b for a, b in zip(dims, dims[1:]))
    n_feat = cfg.n_sparse + 1
    inter_in = n_feat * (n_feat - 1) // 2 + cfg.bot_mlp[-1]
    dims = (inter_in,) + cfg.top_mlp
    mlp_flops += sum(2.0 * a * b for a, b in zip(dims, dims[1:]))
    inter_flops = 2.0 * n_feat * n_feat * cfg.embed_dim

    if shape.kind == "retrieval":
        n_cand = shape.dim("n_candidates")
        query = {"dense": sds((1, cfg.n_dense), F32)}
        cands = sds((n_cand, cfg.bot_mlp[-1]), F32)

        def retrieve(params, query, candidates):
            return dlrm_lib.retrieval_step(params, query, candidates)

        return CellPlan(
            cfg.name, shape, "retrieval_step", retrieve,
            (params_shapes, query, cands),
            (p_shard, {"dense": _named(mesh, rules, None, None)},
             _named(mesh, rules, "candidates", None, shape=(n_cand, cfg.bot_mlp[-1]))),
            None,
            {"model_flops": 2.0 * n_cand * cfg.bot_mlp[-1],
             "n_params": cfg.n_params(), "batch": 1},
        )

    B = shape.dim("batch")
    batch = {
        "dense": sds((B, cfg.n_dense), F32),
        "sparse": sds((B, cfg.n_sparse), I32),
    }
    b_shard = {
        "dense": _named(mesh, rules, "batch", None, shape=(B, cfg.n_dense)),
        "sparse": _named(mesh, rules, "batch", None, shape=(B, cfg.n_sparse)),
    }
    per_ex_flops = mlp_flops + inter_flops
    lookup_bytes = B * cfg.n_sparse * cfg.embed_dim * 4

    if shape.kind == "serve":
        def serve(params, batch):
            return dlrm_lib.serve_step(params, batch, cfg)

        return CellPlan(
            cfg.name, shape, "serve_step", serve,
            (params_shapes, batch), (p_shard, b_shard),
            _named(mesh, rules, "batch"),
            {"model_flops": per_ex_flops * B, "n_params": cfg.n_params(),
             "batch": B, "lookup_bytes": lookup_bytes},
        )

    batch["labels"] = sds((B,), F32)
    b_shard["labels"] = _named(mesh, rules, "batch", shape=(B,))
    opt = optimizer or AdamW(learning_rate=1e-3, weight_decay=0.0)
    opt_shapes = _opt_shapes(opt, params_shapes)
    opt_shard = _shard_tree(mesh, rules, opt.state_logical_axes(logical), opt_shapes)
    step = dlrm_lib.make_train_step(cfg, opt)
    return CellPlan(
        cfg.name, shape, "train_step", step,
        (params_shapes, opt_shapes, batch),
        (p_shard, opt_shard, b_shard),
        (p_shard, opt_shard, None),
        {"model_flops": 3.0 * per_ex_flops * B, "n_params": cfg.n_params(),
         "batch": B, "lookup_bytes": lookup_bytes},
    )


# ---------------------------------------------------------------------------
# TAPER refine-step cell (the paper's technique itself)
# ---------------------------------------------------------------------------


def _gathered(t):
    """A DTensor made whole on every chip (an all-gather), or the tensor."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _taper_cell(cfg: TaperSystemConfig, shape: ShapeSpec, mesh, rules,
                fused: bool = True, dense_ext_to: bool = False,
                backend: str = "cuda") -> CellPlan:
    """``fused`` is the JAX package's choice between two equal field
    functions; the port has the one (``field_from_arrays``)."""
    n = shape.dim("n_vertices")
    m = shape.dim("n_edges")
    trie = synthetic_trie(cfg.n_labels, cfg.trie_depth, branching=2)
    k = cfg.k_partitions

    args = (
        sds((m,), I32), sds((m,), I32),                  # src, dst
        sds((n,), I32),                                  # labels
        sds((n, cfg.n_labels), I32),                     # cnt
        sds((cfg.n_labels,), I32),                       # label vertex counts
        sds((n,), I32),                                  # part
        sds((trie.n_nodes,), F32), sds((trie.n_nodes,), F32),  # p, cond_p
    )
    e = _named(mesh, rules, "edges", shape=(m,))
    v = _named(mesh, rules, "nodes", shape=(n,))
    rep = _replicated(mesh)
    in_sh = (e, e, v, _named(mesh, rules, "nodes", None, shape=(n, cfg.n_labels)), rep, v, rep, rep)

    def refine(src, dst, labels, cnt, lab_vcount, part, p, cond_p):
        from torch.distributed.tensor import DTensor, Replicate

        whole = [_gathered(a) for a in (src, dst, labels, cnt, lab_vcount, part, p, cond_p)]
        out = field_from_arrays(trie, k, *whole, n=n, m=m, backend=backend,
                                dense_ext_to=dense_ext_to)
        if isinstance(src, DTensor):
            out = tuple(DTensor.from_local(o, src.device_mesh,
                                           [Replicate()] * src.device_mesh.ndim,
                                           run_check=False) for o in out)
        return out

    # outputs: alpha (n,N), pr (n,), mass (m,), extro (n,), extroversion (n,)
    # [, ext_to (n, k)] — all sharded along their vertex/edge dim
    vN = _named(mesh, rules, "nodes", None, shape=(n, trie.n_nodes))
    vk = _named(mesh, rules, "nodes", None, shape=(n, k))
    out_sh = (vN, v, e, v, v) + ((vk,) if dense_ext_to else ())

    # DP flops: per depth>=2 trie node, one gather-multiply-scatter over edges
    steps = int((trie.depth >= 2).sum())
    model_flops = 4.0 * m * steps + 4.0 * m * trie.n_nodes
    return CellPlan(
        cfg.name, shape, "taper_refine_step", refine,
        args, in_sh, out_sh,
        {"model_flops": model_flops, "n_vertices": n, "n_edges": m,
         "trie_nodes": trie.n_nodes, "k": k},
    )


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def build_cell(arch: str, shape_name: str, mesh,
               rules: Optional[LogicalAxisRules] = None,
               constrain_activations: bool = True, **kw) -> CellPlan:
    cfg = get_config(arch)
    rules = rules or rules_for(mesh)
    shape = next(s for s in shapes_for(arch) if s.name == shape_name)

    def pick(*names):
        return {k: v for k, v in kw.items() if k in names}

    if cfg.family == "lm":
        plan = _lm_cell(cfg, shape, mesh, rules, **pick("optimizer", "remat"))
    elif cfg.family == "gnn":
        plan = _gnn_cell(cfg, shape, mesh, rules, **pick("optimizer"))
    elif cfg.family == "recsys":
        plan = _dlrm_cell(cfg, shape, mesh, rules, **pick("optimizer"))
    elif cfg.family == "taper":
        plan = _taper_cell(cfg, shape, mesh, rules,
                           **pick("fused", "dense_ext_to", "backend"))
    else:
        raise ValueError(cfg.family)
    plan.mesh = mesh
    plan.rules = rules
    plan.constrain_activations = constrain_activations
    return plan


def all_cells():
    """Every (arch, shape) pair in the assignment (skips documented in
    configs.registry.shapes_for)."""
    out = []
    from repro_torch.configs.registry import list_archs

    for arch in list_archs():
        for s in shapes_for(arch):
            out.append((arch, s.name))
    return out
