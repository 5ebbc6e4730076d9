"""Carry the JAX reference's state across into the port's objects.

TAPER has no weights: its state is the graph, the compiled workload trie,
the partition vector and, between the field and the swap, the extroversion
field.  The models (DLRM, GCN) have parameter pytrees: nested dicts and
lists of arrays.  Each arrives here as plain numpy arrays (read off the
reference's objects by the caller, ``np.asarray`` per leaf), so both
packages can compute on the same state without this package importing the
reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.tpstry import TrieArrays
from repro_torch.core.visitor import ExtroversionResult
from repro_torch.graphs.graph import LabelledGraph

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


def _copy(v):
    return np.array(v, copy=True) if isinstance(v, np.ndarray) else v


def from_reference_arrays(graph: Optional[Mapping] = None,
                          trie: Optional[Mapping] = None,
                          part=None,
                          field: Optional[Mapping] = None) -> PortState:
    """Build the port's objects from the reference's arrays.

    ``graph`` maps ``n``, ``labels``, ``label_names``, ``src`` and ``dst``
    (the edge list may be in any order: the graph re-sorts it by
    ``(src, dst)``), ``trie`` maps :data:`TRIE_FIELDS`, ``field`` maps
    :data:`RESULT_FIELDS` and ``part`` is a partition vector.  Arrays are
    copied; each argument is optional.
    """
    out = PortState()
    if graph is not None:
        out.graph = LabelledGraph(
            n=int(graph["n"]),
            labels=np.array(graph["labels"], np.int32),
            label_names=list(graph["label_names"]),
            src=np.array(graph["src"], np.int32),
            dst=np.array(graph["dst"], np.int32),
        )
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


def dlrm_params_from_reference(tree: Mapping, device="cpu") -> Dict:
    """The port's DLRM parameters from the reference's ``models.dlrm.init``
    pytree (``{"embedding", "bot", "top"}``), copied onto ``device``."""
    if set(tree) != {"embedding", "bot", "top"}:
        raise ValueError(f"DLRM parameters have keys {sorted(tree)}, want "
                         "['bot', 'embedding', 'top']")
    _layers(tree["bot"], "bot")
    _layers(tree["top"], "top")
    return _tensors(tree, device)


def gcn_params_from_reference(tree: Mapping, device="cpu") -> Dict:
    """The port's GCN parameters from the reference's
    ``models.gnn.gcn.init`` pytree (``{"layers": [{"w", "b"}, ...]}``),
    copied onto ``device``."""
    if set(tree) != {"layers"}:
        raise ValueError(f"GCN parameters have keys {sorted(tree)}, want ['layers']")
    _layers(tree["layers"], "layers")
    return _tensors(tree, device)
