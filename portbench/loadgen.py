"""The one traffic generator: reads a mix file (``traffic/<name>.json``) and
yields the partitions that the window hands to ``Taper.field``.

A mix names its start (``hash`` or ``block``), the share of vertices moved
before each call (``move_frac``), its loop (a closed loop of one caller) and
how long set-up warms the calls up (``warm_seconds``).
Each call's partition is the start with a fresh seeded ``move_frac`` of the
vertices, drawn without replacement, each moved to a part drawn uniformly
from the other ``k - 1``.  Every draw starts from the start, not from the
previous call's partition, so consecutive calls differ and the regime stays
that of the start.  The draws run on the device from their own generator and
are copied to the host, where the program takes its partition.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

STARTS = ("hash", "block")


def check_mix(mix: Dict) -> None:
    """Raise unless the generator can run ``mix``."""
    if mix.get("start") not in STARTS:
        raise ValueError(f"traffic {mix.get('name')!r}: start must be one of {STARTS}")
    if not 0.0 < float(mix["move_frac"]) <= 1.0:
        raise ValueError(f"traffic {mix.get('name')!r}: move_frac must lie in (0, 1]")
    if float(mix.get("warm_seconds", -1)) < 0:
        raise ValueError(f"traffic {mix.get('name')!r}: warm_seconds must be given, >= 0")
    if mix.get("loop") != "closed" or int(mix.get("callers", 0)) != 1:
        raise ValueError(f"traffic {mix.get('name')!r}: only a closed loop of one caller is generated")


def hash_start(n: int, k: int, seed: int) -> np.ndarray:
    """A balanced pseudo-random partitioning by a mixed hash of the vertex id
    and the seed (the port's ``hash_partition`` mixing, frozen here)."""
    ids = np.arange(n, dtype=np.uint64)
    mix = (int(seed) * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ids + np.uint64(mix)
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return (x % np.uint64(k)).astype(np.int32)


def block_start(labels: np.ndarray, k: int) -> np.ndarray:
    """Each vertex's rank within its label class cut into ``k`` equal blocks.
    The graph maker stripes each class over its layer-0 communities in id
    order, so the blocks keep those communities together."""
    labels = np.asarray(labels)
    count = np.bincount(labels)
    first = np.concatenate([[0], np.cumsum(count)[:-1]])
    rank = np.arange(labels.size, dtype=np.int64) - first[labels]
    return ((rank * k) // count[labels]).astype(np.int32)


def start_partition(mix: Dict, labels: np.ndarray, k: int, seed: int) -> np.ndarray:
    if mix["start"] == "hash":
        return hash_start(labels.size, k, seed)
    return block_start(labels, k)


class Draws:
    """The partitions of one run, in order: ``next()`` gives the i-th as a
    device tensor (int32).  A second ``Draws`` made with the same arguments
    gives the same sequence."""

    def __init__(self, start: np.ndarray, k: int, move_frac: float, seed: int, device):
        self.device = torch.device(device)
        self.start = torch.as_tensor(start, device=self.device).long()
        self.n, self.k = int(start.size), int(k)
        self.moved = max(1, int(round(float(move_frac) * self.n)))
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

    def next(self) -> torch.Tensor:
        idx = torch.randperm(self.n, generator=self.gen, device=self.device)[:self.moved]
        shift = torch.randint(1, self.k, (self.moved,), generator=self.gen, device=self.device)
        part = self.start.clone()
        part[idx] = (self.start[idx] + shift) % self.k
        return part.to(torch.int32)
