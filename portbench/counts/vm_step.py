"""Bytes and operations of one ``vm_step`` launch, from the graph, the
partitioning and the trie's width alone.

One depth step of the field advances every trie column of every vertex over
the local edges.  Whatever implements it has to read, at the least: for each
live (local) edge its source id and its weight; the row offsets and the row
label of each destination; the transition's column form (two (L, N) tables);
once, each alpha row that a live edge gathers (N floats); and it writes the
(n, N) output once.  All are 4-byte words.  Operations: a gather-multiply, a
scale and an add per live edge and column.  Cut edges carry weight 0 and are
not counted, so the count is the same whatever layout the step reads.
"""
from __future__ import annotations

from typing import Tuple

import torch


def launch_cost(src: torch.Tensor, dst: torch.Tensor, part: torch.Tensor, n: int,
                n_cols: int, n_labels: int) -> Tuple[int, int]:
    """``(bytes, flops)`` of one launch over the directed edge list
    ``src, dst`` (each edge in both directions) under partitioning ``part``."""
    part = part.to(src.device).long()
    live = part[src] == part[dst]
    n_live = int(live.sum())
    gathered = torch.zeros(n, dtype=torch.bool, device=src.device)
    gathered[src[live]] = True
    n_gathered = int(gathered.sum())
    words = (n + 1) + 2 * n_live + n + n * n_cols + 2 * n_labels * n_cols
    return 4 * words + 4 * n_cols * n_gathered, 3 * n_live * n_cols
