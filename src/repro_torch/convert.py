"""Carry the JAX reference's state across into the port's objects.

TAPER has no weights: its state is the graph, the compiled workload trie,
the partition vector and, between the field and the swap, the extroversion
field.  Each arrives here as plain numpy arrays (read off the reference's
objects by the caller), so both packages can compute on the same state
without this package importing the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

import numpy as np

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
