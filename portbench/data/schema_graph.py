"""The benchmark's graph maker: a schema-constrained labelled graph from a seed.

A frozen, vectorised copy of the port's ``graphs/generators.py::schema_graph``
that runs on the device with a seeded ``torch.Generator``: the same label
shares, edge types, endpoint skew and latent communities, drawn in a few large
calls instead of a loop over communities.  Both the program and the reference
are handed the arrays it returns.

Per label class, vertices take consecutive ids and are striped over
``n_comm`` latent communities (layer 0) or a seeded permutation of those
stripes (each further layer).  An edge of type ``(lu, lv, weight, layer)``
takes its ``lu`` endpoint by zipf-like rank ``floor(count * u ** (1 + skew))``
over its class; its ``lv`` endpoint, with probability ``p_intra``, by the same
law over the members of the source's community in ``lv``'s class (in id
order), else over the whole class.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def _zipf(gen: torch.Generator, size: torch.Tensor, count: int, skew: float,
          device) -> torch.Tensor:
    """Ranks in ``[0, size)`` (``size`` a scalar or one per draw), small
    ranks favoured: ``floor(size * u ** (1 + skew))``."""
    u = torch.rand(count, generator=gen, device=device, dtype=torch.float64)
    idx = torch.floor(size * u ** (1.0 + skew)).long()
    return torch.minimum(idx, torch.clamp_min(torch.as_tensor(size, device=device) - 1, 0))


def label_counts(spec: Dict) -> np.ndarray:
    """Vertices per label: the shares rounded, the largest class taking the rest."""
    n = int(spec["n"])
    props = np.asarray(spec["label_props"], dtype=np.float64)
    props = props / props.sum()
    counts = np.maximum(1, np.round(props * n).astype(np.int64))
    counts[np.argmax(counts)] += n - counts.sum()
    return counts


def schema_graph(spec: Dict, seed: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(labels (n,) int32, edges (e, 2) int64)`` on ``device`` for the graph
    section ``spec`` of a configuration file.  The edges are undirected and
    may hold duplicates and self loops, as the port's generator leaves them."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    n = int(spec["n"])
    names = list(spec["labels"])
    name_to_id = {s: i for i, s in enumerate(names)}
    counts = label_counts(spec)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    n_comm = max(int(spec["min_communities"]), n // int(spec["community_size"]))
    schema = spec["edge_schema"]
    n_layers = 1 + max(int(e[3]) for e in schema)
    skew, p_intra = float(spec["skew"]), float(spec["p_intra"])

    labels = torch.repeat_interleave(
        torch.arange(len(names), dtype=torch.int32, device=device),
        torch.as_tensor(counts, device=device))
    comm = torch.empty((n_layers, n), dtype=torch.int64, device=device)
    for li, c in enumerate(counts):
        lo, hi = int(offsets[li]), int(offsets[li + 1])
        stripes = (torch.arange(int(c), device=device) * n_comm) // int(c)
        comm[0, lo:hi] = stripes
        for layer in range(1, n_layers):
            comm[layer, lo:hi] = stripes[torch.randperm(int(c), generator=gen, device=device)]
    # members of each (layer, class, community), in ascending id order, and
    # where each community starts among them
    cells = {}
    grid = torch.arange(n_comm + 1, device=device)
    for layer in range(n_layers):
        for li in range(len(names)):
            lo, hi = int(offsets[li]), int(offsets[li + 1])
            keys, order = torch.sort(comm[layer, lo:hi], stable=True)
            cells[(layer, li)] = (lo + order, torch.searchsorted(keys, grid))

    target = int(n * float(spec["avg_degree"]) / 2)
    weights = np.asarray([float(e[2]) for e in schema], dtype=np.float64)
    weights = weights / weights.sum()
    per_type = np.maximum(1, np.round(weights * target).astype(np.int64))
    chunks = []
    for (lu, lv, _, layer), cnt in zip(schema, per_type):
        iu, iv, cnt, layer = name_to_id[lu], name_to_id[lv], int(cnt), int(layer)
        us = int(offsets[iu]) + _zipf(gen, int(counts[iu]), cnt, skew, device)
        intra = torch.rand(cnt, generator=gen, device=device) < p_intra
        vs = int(offsets[iv]) + _zipf(gen, int(counts[iv]), cnt, skew, device)
        members, start = cells[(layer, iv)]
        uc = comm[layer, us]
        first = start[uc]
        size = start[uc + 1] - first
        pick = first + _zipf(gen, size, cnt, skew, device)
        pick = members[torch.clamp(pick, 0, members.numel() - 1)]
        vs = torch.where(intra & (size > 0), pick, vs)
        chunks.append(torch.stack([us, vs], dim=1))
    return labels, torch.cat(chunks)
