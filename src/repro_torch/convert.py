"""Carry the JAX reference's state across into the port's objects.

TAPER has no weights: its state is the graph (with its mutation version
and log, once it has changed), the compiled workload trie, the partition
vector, the online driver's query-frequency sketch and, between the field
and the swap, the extroversion field.  The models (DLRM, the four GNNs, the
LM transformer) have parameter pytrees: nested dicts and lists of arrays.
Each arrives here as plain numpy arrays (read off the reference's objects
by the caller, ``np.asarray`` per leaf), so both packages can compute on
the same state without this package importing the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Set

import numpy as np
import torch

from repro_torch.core.tpstry import TrieArrays
from repro_torch.core.visitor import ExtroversionResult
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs.graph import LabelledGraph, mutation_log_from_state
from repro_torch.workload.sketch import FrequencySketch

TRIE_FIELDS = ("parent", "label", "depth", "p", "cond_p", "child_index",
               "is_leaf", "n_labels")
RESULT_FIELDS = ("alpha", "pr", "edge_mass", "extro_mass", "extroversion",
                 "ext_to", "total_extroversion")


@dataclass
class PortState:
    graph: Optional[LabelledGraph] = None
    trie: Optional[TrieArrays] = None
    part: Optional[np.ndarray] = None
    field: Optional[ExtroversionResult] = None
    sketch: Optional[FrequencySketch] = None


def _copy(v):
    return np.array(v, copy=True) if isinstance(v, np.ndarray) else v


def from_reference_arrays(graph: Optional[Mapping] = None,
                          trie: Optional[Mapping] = None,
                          part=None,
                          field: Optional[Mapping] = None,
                          sketch: Optional[Mapping] = None) -> PortState:
    """Build the port's objects from the reference's arrays.

    ``graph`` maps ``n``, ``labels``, ``label_names``, ``src`` and ``dst``
    (the edge list may be in any order: the graph re-sorts it by
    ``(src, dst)``) and, for a graph that has mutated, optionally
    ``version`` and ``mutation_log``, the ``(arrays, meta)`` pair of the
    reference's ``mutation_log_state`` — so an executor's cached counts
    patch across the same records as they would there.  ``trie`` maps
    :data:`TRIE_FIELDS`, ``field`` maps :data:`RESULT_FIELDS`, ``part`` is
    a partition vector and ``sketch`` is a ``FrequencySketch.state_dict()``
    (half life, clock, counts, stamps and query texts).  Arrays are copied;
    each argument is optional.
    """
    out = PortState()
    if graph is not None:
        out.graph = LabelledGraph(
            n=int(graph["n"]),
            labels=np.array(graph["labels"], np.int32),
            label_names=list(graph["label_names"]),
            src=np.array(graph["src"], np.int32),
            dst=np.array(graph["dst"], np.int32),
            version=int(graph.get("version", 0)),
        )
        if graph.get("mutation_log") is not None:
            arrays, meta = graph["mutation_log"]
            out.graph.mutation_log.extend(mutation_log_from_state(
                {k: np.array(v, copy=True) for k, v in arrays.items()}, meta))
    if sketch is not None:
        out.sketch = FrequencySketch.from_state(sketch)
    if trie is not None:
        out.trie = TrieArrays(**{f: _copy(trie[f]) for f in TRIE_FIELDS})
    if part is not None:
        out.part = np.array(part, np.int32)
    if field is not None:
        out.field = ExtroversionResult(
            **{f: _copy(field[f]) for f in RESULT_FIELDS})
    return out


def _tensors(tree, device, path="params"):
    if isinstance(tree, Mapping):
        return {k: _tensors(v, device, f"{path}.{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v, device, f"{path}[{i}]") for i, v in enumerate(tree)]
    a = np.asarray(tree)
    if a.dtype != np.float32:
        raise ValueError(f"{path}: expected float32 parameters, got {a.dtype}")
    return torch.tensor(a, device=device)


def _layers(tree, path):
    if not isinstance(tree, (list, tuple)) or not all(
            isinstance(p, Mapping) and set(p) == {"w", "b"} for p in tree):
        raise ValueError(f"{path}: expected a list of {{'w', 'b'}} layers")


def dlrm_params_from_reference(tree: Mapping, device: DeviceLike = None) -> Dict:
    """The port's DLRM parameters from the reference's ``models.dlrm.init``
    pytree (``{"embedding", "bot", "top"}``), copied onto ``device``
    (default ``"cuda"``, through ``resolve_device``)."""
    if set(tree) != {"embedding", "bot", "top"}:
        raise ValueError(f"DLRM parameters have keys {sorted(tree)}, want "
                         "['bot', 'embedding', 'top']")
    _layers(tree["bot"], "bot")
    _layers(tree["top"], "top")
    return _tensors(tree, resolve_device(device))


def gcn_params_from_reference(tree: Mapping, device: DeviceLike = None) -> Dict:
    """The port's GCN parameters from the reference's
    ``models.gnn.gcn.init`` pytree (``{"layers": [{"w", "b"}, ...]}``),
    copied onto ``device`` (default ``"cuda"``, through ``resolve_device``)."""
    if set(tree) != {"layers"}:
        raise ValueError(f"GCN parameters have keys {sorted(tree)}, want ['layers']")
    _layers(tree["layers"], "layers")
    return _tensors(tree, resolve_device(device))


def _keys(tree, path: str, want: Set[str]) -> None:
    if not isinstance(tree, Mapping) or set(tree) != want:
        have = sorted(tree) if isinstance(tree, Mapping) else type(tree).__name__
        raise ValueError(f"{path} has keys {have}, want {sorted(want)}")


def lm_params_from_reference(tree: Mapping, cfg, device: DeviceLike = None) -> Dict:
    """The port's LM parameters from the reference's
    ``models.transformer.init`` pytree for the ``LMConfig`` ``cfg``, copied
    onto ``device`` (default ``"cuda"``, through ``resolve_device``).

    Checks the key tree: ``embed``, ``layers.{attn, ffn, ln1, ln2}``,
    ``final_norm.scale``, and ``lm_head`` unless the embeddings are tied;
    ``attn`` holds ``wq, wk, wv, wo``, with ``bq, bk, bv`` when ``cfg`` has
    QKV bias and ``q_norm, k_norm`` when it has QK-norm; ``ffn`` is dense
    (``gate, up, down``) or, for a MoE ``cfg``, ``router.w, gate, up,
    down``, with ``shared.{gate, up, down}`` when it has shared experts.
    Arrays must be float32."""
    _keys(tree, "params", {"embed", "layers", "final_norm"}
          | (set() if cfg.tie_embeddings else {"lm_head"}))
    _keys(tree["layers"], "layers", {"attn", "ffn", "ln1", "ln2"})
    _keys(tree["final_norm"], "final_norm", {"scale"})
    ffn = tree["layers"]["ffn"]
    if cfg.moe:
        _keys(ffn, "layers.ffn", {"router", "gate", "up", "down"}
              | ({"shared"} if cfg.moe.n_shared else set()))
        _keys(ffn["router"], "layers.ffn.router", {"w"})
        if cfg.moe.n_shared:
            _keys(ffn["shared"], "layers.ffn.shared", {"gate", "up", "down"})
    else:
        _keys(ffn, "layers.ffn", {"gate", "up", "down"})
    _keys(tree["layers"]["attn"], "layers.attn", {"wq", "wk", "wv", "wo"}
          | ({"bq", "bk", "bv"} if cfg.attn_bias else set())
          | ({"q_norm", "k_norm"} if cfg.qk_norm else set()))
    return _tensors(tree, resolve_device(device))


def _mlp(tree, path: str, n_layers: int) -> None:
    _layers(tree, path)
    if len(tree) != n_layers:
        raise ValueError(f"{path}: {len(tree)} dense layers, want {n_layers}")


def gin_params_from_reference(tree: Mapping, device: DeviceLike = None) -> Dict:
    """The port's GIN parameters from the reference's ``models.gnn.gin.init``
    pytree (``layers[i].{mlp: [2 × {w, b}], eps}`` with ``eps`` a 0-d
    array, ``readout.{w, b}``), copied onto ``device`` (default
    ``"cuda"``)."""
    _keys(tree, "params", {"layers", "readout"})
    _keys(tree["readout"], "readout", {"w", "b"})
    for i, layer in enumerate(tree["layers"]):
        _keys(layer, f"layers[{i}]", {"mlp", "eps"})
        _mlp(layer["mlp"], f"layers[{i}].mlp", 2)
        if np.ndim(layer["eps"]) != 0:
            raise ValueError(f"layers[{i}].eps: expected a 0-d array")
    return _tensors(tree, resolve_device(device))


def nequip_params_from_reference(tree: Mapping, device: DeviceLike = None) -> Dict:
    """The port's NequIP parameters from the reference's
    ``models.gnn.nequip.init`` pytree (``embed``, ``layers[i].{radial: [2 ×
    {w, b}], lin.{l0..l_max}, gate}``, no ``gate`` at ``l_max`` 0;
    ``readout``: [2 × {w, b}]), copied onto ``device`` (default
    ``"cuda"``)."""
    _keys(tree, "params", {"embed", "layers", "readout"})
    _mlp(tree["readout"], "readout", 2)
    for i, layer in enumerate(tree["layers"]):
        n_l = len(layer.get("lin", {}))
        _keys(layer, f"layers[{i}]", {"radial", "lin"} | ({"gate"} if n_l > 1 else set()))
        _keys(layer["lin"], f"layers[{i}].lin", {f"l{l}" for l in range(n_l)})
        _mlp(layer["radial"], f"layers[{i}].radial", 2)
    return _tensors(tree, resolve_device(device))


def equiformer_params_from_reference(tree: Mapping, device: DeviceLike = None) -> Dict:
    """The port's EquiformerV2 parameters from the reference's
    ``models.gnn.equiformer.init`` pytree (``embed``, ``layers[i].{w0,
    radial, attn, ffn1, ffn2, ffn_gate, out, w{m}_1, w{m}_2 for m = 1 ..
    m_max}``, ``readout``; ``radial``, ``attn`` and ``readout`` 2 × {w,
    b}), copied onto ``device`` (default ``"cuda"``)."""
    _keys(tree, "params", {"embed", "layers", "readout"})
    _mlp(tree["readout"], "readout", 2)
    for i, layer in enumerate(tree["layers"]):
        m_max = sum(1 for k in layer if k.endswith("_1"))
        _keys(layer, f"layers[{i}]",
              {"w0", "radial", "attn", "ffn1", "ffn2", "ffn_gate", "out"}
              | {f"w{m}_{j}" for m in range(1, m_max + 1) for j in (1, 2)})
        _mlp(layer["radial"], f"layers[{i}].radial", 2)
        _mlp(layer["attn"], f"layers[{i}].attn", 2)
    return _tensors(tree, resolve_device(device))
