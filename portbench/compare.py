"""The comparison that decides ``correct``.

Each compared call's field, as the program returned it to the host, is held
against the plain reference's float64 field of the same graph and
partitioning.  Every quantity of the field is a sum of products of
nonnegative factors, so each entry is compared by its own relative error
``|x - r| / |r|``; where the reference is exactly 0, the program has to give
exactly 0 (else the error is infinite).  Alpha's columns are matched by each
trie node's label path, not by index.  ``structure`` counts outputs whose
shape, trie or presence differs from the reference's; its limit is 0.
"""
from __future__ import annotations

import math
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

#: the field's outputs, in the order they are reported
ARRAYS = ("alpha", "pr", "edge_mass", "extro_mass", "extroversion", "ext_to")
_BIG = sys.float_info.max


def _on(x, device) -> torch.Tensor:
    """``x`` (a numpy array or a tensor) as a float64 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float64)
    return torch.as_tensor(np.ascontiguousarray(x), device=device).double()


def relerr(x: torch.Tensor, r: torch.Tensor) -> float:
    """Largest ``|x - r| / |r|`` over the entries (float64); infinite where
    ``r`` is 0 and ``x`` is not, or where ``x`` is not finite."""
    x, r = x.double(), r.double()
    if not bool(torch.isfinite(x).all()):
        return math.inf
    nz = r != 0
    if bool((x[~nz] != 0).any()):
        return math.inf
    if not bool(nz.any()):
        return 0.0
    return float(((x[nz] - r[nz]).abs() / r[nz].abs()).max())


def column_paths(parent: Sequence[int], label: Sequence[int],
                 label_names: Sequence[str]) -> List[tuple]:
    """Each trie column's label path, from a compiled trie's parent and label
    arrays (parents come before children)."""
    paths: List[tuple] = []
    for p, lab in zip(parent, label):
        paths.append(() if p < 0 else paths[int(p)] + (label_names[int(lab)],))
    return paths


def compare(prog, ref: Dict[str, Optional[torch.Tensor]], prog_paths: Sequence[tuple],
            ref_paths: Sequence[tuple], dense_ext_to: bool) -> Dict[str, float]:
    """Compared numbers of one call: ``prog`` has the program's outputs as
    attributes (numpy arrays, or tensors for the control), ``ref`` the
    reference's tensors."""
    device = ref["alpha"].device
    out: Dict[str, float] = {"structure": 0.0}
    index = {p: i for i, p in enumerate(ref_paths)}
    cols = [index.get(p) for p in prog_paths]
    if None in cols or len(set(cols)) != len(ref_paths) or len(cols) != len(ref_paths):
        out["structure"] += 1
    for name in ARRAYS:
        r = ref[name]
        x = getattr(prog, name, None)
        if name == "ext_to" and not dense_ext_to:
            if x is not None:
                out["structure"] += 1
            continue
        want = (r.shape[0], len(prog_paths)) if name == "alpha" else tuple(r.shape)
        if x is None or tuple(x.shape) != want:
            out["structure"] += 1
            out[f"{name}_relerr"] = math.inf
            continue
        if name == "alpha":
            if out["structure"]:
                out["alpha_relerr"] = math.inf
                continue
            err = 0.0
            for j, c in enumerate(cols):
                err = max(err, relerr(_on(x[:, j], device), r[:, c]))
            out["alpha_relerr"] = err
        else:
            out[f"{name}_relerr"] = relerr(_on(x, device), r)
    total = float(getattr(prog, "total_extroversion", math.nan))
    rt = float(ref["total_extroversion"])
    out["total_extroversion_relerr"] = (
        math.inf if not math.isfinite(total) else
        (0.0 if rt == total else abs(total - rt) / abs(rt) if rt else math.inf))
    return out


def merge(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """The largest reading of each number over the compared calls."""
    out: Dict[str, float] = {}
    for reading in readings:
        for name, v in reading.items():
            out[name] = max(out.get(name, -math.inf), math.inf if math.isnan(v) else v)
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Each limited number beside its limit, with ``ok``; a number that is
    limited but was not read fails."""
    out = {}
    for name, limit in limits.items():
        v = numbers.get(name, math.inf)
        out[name] = {"value": v if math.isfinite(v) else _BIG, "limit": limit,
                     "ok": bool(v <= limit)}
    return out
