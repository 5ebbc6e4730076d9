"""Vectorised Visitor-Matrix extroversion field (paper §2.3, §3.2, §5.4).

The paper's Alg. 1 builds Visitor-Matrix rows corecursively per vertex.  As
in the JAX package, it is reformulated as a depth-stratified sparse
recurrence over the edge list:

  state    alpha[v, n]  = total probability of workload-legal *intra-partition*
                          paths ending at v whose label string is trie node n
  base     alpha[v, n1] = p(n1) / |{u : l(u) = label(n1)}|        (depth-1 n1)
  step     alpha[w, n'] += alpha[u, parent(n')] * cond_p(n')
                           / cnt[u, l(w)]          over local edges (u, w)
  masses   mass[u→w]    = sum_n alpha[u, parent(c)] * cond_p(c) / cnt[u, l(w)]
                          for c = child(n, l(w))   over ALL edges
  outputs  Pr(v)        = sum_{n non-leaf} alpha[v, n]
           extroversion = (sum of mass over cut edges out of v) / Pr(v)
           introversion = 1 - extroversion  (termination mass is intra, §4.2)

Two backends:

* ``"torch"`` — the plain fused field (the JAX package's ``field_fn_fused``):
  per depth, one batched gather / elementwise / segment-sum pass over all
  trie nodes of that depth.  The CPU path.
* ``"cuda"`` — the step runs as the hand-written ``vm_step`` kernel over the
  graph's dst-sorted CSR (the counterpart of the JAX package's
  ``_pallas_field``), as a chain of *delta* states: ``beta_d`` holds only
  the depth-``d`` trie columns, so one application of the full transition
  tensor per depth advances every state without double counting.  CUDA
  devices only; the default there.

Both backends round every product and add every sum in the order of the
reference's fused ``jnp`` field: each per-edge message is
``((alpha * cond_p) * inv_cnt) * local``; per-edge masses sum a depth's
trie columns left to right; every segment sum runs over contiguous,
pre-sorted runs, each summed in edge order from 0 — the order of a
sequential scatter-add (``torch.segment_reduce`` on 2-D values, no
atomics).  So the field repeats bitwise from run to run, on any device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.tpstry import TrieArrays
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs.graph import LabelledGraph
from repro_torch.kernels.segment_spmm.ref import segment_sum
from repro_torch.kernels.vm_step.ops import vm_step
from repro_torch.kernels.vm_step.ref import transition_columns

_EPS = 1e-30

#: the port's field backends: the CUDA kernel, and the plain torch field
FIELD_BACKENDS = ("cuda", "torch")


@dataclass
class ExtroversionResult:
    """Per-vertex/per-edge extroversion field for one partitioning."""

    alpha: np.ndarray         # (n, N) path-state probabilities
    pr: np.ndarray            # (n,)  total traversal probability through v
    edge_mass: np.ndarray     # (m,)  traversal probability mass per directed edge
    extro_mass: np.ndarray    # (n,)  external mass out of v
    extroversion: np.ndarray  # (n,)  extro_mass / pr  (0 where pr == 0)
    ext_to: Optional[np.ndarray]  # (n, k) external mass per destination part
                                  # (None under the two-phase §Perf-T2 path:
                                  # swap computes candidate rows lazily)
    total_extroversion: float  # sum of extro_mass — TAPER's objective

    @property
    def introversion(self) -> np.ndarray:
        return np.where(self.pr > 0, 1.0 - self.extroversion, 1.0)


def _prior_columns(depth, labels_n, N, vlabels, lab_vcount, p, n):
    """Depth-1 prior columns ``alpha[v, n1] = p(n1) / |{u : l(u)=label(n1)}|``,
    in float32 division on the device, shared by both backends."""
    zero = torch.zeros((), dtype=torch.float32, device=vlabels.device)
    cols = []
    for i in range(N):
        if depth[i] == 1:
            li = int(labels_n[i])
            prior = p[i] / torch.clamp_min(lab_vcount[li].to(torch.float32), 1.0)
            cols.append(torch.where(vlabels == li, prior, zero))
        else:
            cols.append(torch.zeros(n, dtype=torch.float32, device=vlabels.device))
    if not N:
        return torch.zeros((n, 0), dtype=torch.float32, device=vlabels.device)
    return torch.stack(cols, dim=1)


def _field_aggregates(counted_nodes, k, dense_ext_to, alpha, mass, dev,
                      part, local, n):
    """Pr / extroversion / (optional) ext_to tail, shared by both backends.

    The edge list is sorted by source, so per-source sums are segment sums
    over the out-degree runs; ``ext_to`` stably sorts the edges by
    ``src * k + part[dst]`` first."""
    pr = torch.zeros(n, dtype=torch.float32, device=alpha.device)
    for i in counted_nodes:
        pr = pr + alpha[:, i]
    ext_mass = mass * (1.0 - local)
    extro_mass = segment_sum(ext_mass, dev["out_deg"])
    extroversion = torch.where(
        pr > _EPS, extro_mass / torch.clamp_min(pr, _EPS), 0.0)
    ext_to = None
    if dense_ext_to:
        key = dev["src"] * k + part[dev["dst"]]
        order = torch.argsort(key, stable=True)
        ext_to = segment_sum(ext_mass[order],
                             torch.bincount(key, minlength=n * k))
        ext_to = ext_to.reshape(n, k)
    return pr, extro_mass, extroversion, ext_to


def _device_inputs(g: LabelledGraph, pre: Dict, cnt, lab_vcount,
                   device: torch.device) -> Dict:
    """Device-resident copies of the partition-independent field inputs.

    Cached inside the caller's ``_precomputed`` dict (Taper keeps one per
    graph) next to the graph's ``version`` and the device, so repeated
    iterations re-use the same buffers: only the partition vector crosses
    host->device per iteration.  After a mutation the stale version's
    buffers are dropped before the new ones are uploaded (with the CSR's
    new row plan), so one version's buffers are held at a time."""
    key = (g.version, device)
    dev = pre.get("_dev")
    if dev is not None and pre.get("_dev_key") == key:
        return dev
    pre["_dev"] = dev = None      # free the stale version's buffers first
    csr = g.vm_csr()

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    dev = {
        "src": put(g.src, torch.int64),
        "dst": put(g.dst, torch.int64),
        "labels": put(g.labels, torch.int64),
        "labels_i32": put(g.labels, torch.int32),
        # float32 division on the device, as the reference field does
        "inv_cnt": 1.0 / torch.clamp_min(put(cnt, torch.float32), 1.0),
        "lab_vcount": put(lab_vcount, torch.int64),
        "out_deg": put(np.diff(g.row_ptr), torch.int64),
        # checked and row-planned once per graph version, when the graph made it
        "csr": csr.to(device),
        "in_deg": put(np.diff(csr.row_ptr), torch.int64),
    }
    dev["dst_lab"] = dev["labels"][dev["dst"]]
    # per CSR slot: 1 / cnt[src, label(dst)], gathered from the same table
    dev["csr_inv_cnt"] = dev["inv_cnt"][dev["src"], dev["dst_lab"]][dev["csr"].order]
    pre["_dev"] = dev
    pre["_dev_key"] = key
    return dev


_TRANSITION_CACHE: Dict[Tuple, Tuple[np.ndarray, np.ndarray]] = {}


def _capped_transition(trie: TrieArrays, depth_cap: int):
    """The trie transition in its column form ``(par, val)``, each
    ``(L, N)``, with children beyond ``depth_cap`` zeroed (§5.2.2 time
    heuristic).  Cached per (topology, probabilities); bounded so drifting
    workload frequencies (a fresh ``cond_p`` per invocation) cannot grow the
    cache without limit."""
    key = (trie.topology_signature(), int(depth_cap), trie.cond_p.tobytes())
    cols = _TRANSITION_CACHE.get(key)
    if cols is None:
        par, val = transition_columns(trie.parent, trie.label, trie.cond_p,
                                      trie.n_labels)
        if depth_cap < trie.max_depth:
            val[:, trie.depth > depth_cap] = 0.0
        while len(_TRANSITION_CACHE) >= 8:
            _TRANSITION_CACHE.pop(next(iter(_TRANSITION_CACHE)))
        cols = _TRANSITION_CACHE[key] = (par, val)
    return cols


def _depth_nodes(trie: TrieArrays, max_depth: int) -> List[List[int]]:
    """Trie nodes of each depth 2..max_depth (compile() sorts by depth)."""
    return [[c for c in range(trie.n_nodes) if trie.depth[c] == d]
            for d in range(2, max_depth + 1)]


def _depth_contrib(alpha, nodes_d, trie, cond_p, dev):
    """(m, n_d) per-edge messages of one depth:
    ``((alpha[src, parent(c)] * cond_p(c)) * inv_cnt[src, l(c)]) * [l(dst) == l(c)]``."""
    device = alpha.device
    pars = torch.as_tensor(trie.parent[nodes_d].astype(np.int64), device=device)
    labs = torch.as_tensor(trie.label[nodes_d].astype(np.int64), device=device)
    cols = torch.as_tensor(np.asarray(nodes_d, np.int64), device=device)
    a_par = alpha[:, pars][dev["src"]]
    coef = cond_p[cols][None, :]
    ic = dev["inv_cnt"][:, labs][dev["src"]]
    lab_mask = (dev["dst_lab"][:, None] == labs[None, :]).to(torch.float32)
    return a_par * coef * ic * lab_mask


def _row_sum(contrib: torch.Tensor) -> torch.Tensor:
    """Sum of the columns of ``contrib``, left to right."""
    out = contrib[:, 0]
    for j in range(1, contrib.shape[1]):
        out = out + contrib[:, j]
    return out


def _field(g: LabelledGraph, trie: TrieArrays, part: np.ndarray, k: int,
           depth_cap: int, pre: Dict, dense_ext_to: bool, backend: str,
           device: torch.device):
    n, m, N = g.n, g.m, trie.n_nodes
    cnt = pre.get("cnt")
    if cnt is None:
        cnt = g.neighbor_label_counts()
    lab_vcount = pre.get("lab_vcount")
    if lab_vcount is None:
        lab_vcount = g.label_counts()
    dev = _device_inputs(g, pre, cnt, lab_vcount, device)

    part_dev = torch.as_tensor(np.asarray(part, np.int64), device=device)
    local = (part_dev[dev["src"]] == part_dev[dev["dst"]]).to(torch.float32)
    cond_p = torch.as_tensor(trie.cond_p, device=device)
    alpha = _prior_columns(trie.depth, trie.label, N, dev["labels"],
                           dev["lab_vcount"],
                           torch.as_tensor(trie.p, device=device), n)
    max_depth = min(trie.max_depth, depth_cap)
    if backend == "cuda":
        # device-resident column form of the transition, re-uploaded only
        # when the trie probabilities (or depth cap) change — not per iteration
        T_key = (trie.topology_signature(), int(depth_cap),
                 trie.cond_p.tobytes(), device)
        t_hit = pre.get("_T_dev")
        if t_hit is None or t_hit[0] != T_key:
            t_hit = (T_key, tuple(torch.as_tensor(a, device=device)
                                  for a in _capped_transition(trie, depth_cap)))
            pre["_T_dev"] = t_hit
        par, val = t_hit[1]
        # local-edge weights in CSR order (local is 0/1, so exact)
        w = dev["csr_inv_cnt"] * local[dev["csr"].order]
        beta = alpha

    mass = torch.zeros(m, dtype=torch.float32, device=device)
    for nodes_d in _depth_nodes(trie, max_depth):
        if not nodes_d:
            break
        contrib = _depth_contrib(alpha, nodes_d, trie, cond_p, dev)
        # per-edge mass of the depth step over ALL edges (cut + local)
        mass = mass + _row_sum(contrib)
        if backend == "cuda":
            # the DP itself advances over local edges only — vm_step kernel
            beta = vm_step(beta, par, val, dev["csr"], w, dev["labels_i32"])
            alpha = alpha + beta
        else:
            upd = segment_sum((contrib * local[:, None])[dev["csr"].order],
                              dev["in_deg"])
            cols = torch.as_tensor(np.asarray(nodes_d, np.int64), device=device)
            alpha[:, cols] += upd

    counted = [
        i for i in range(N)
        if 1 <= int(trie.depth[i]) < max_depth and not bool(trie.is_leaf[i])
    ]
    pr, extro_mass, extroversion, ext_to = _field_aggregates(
        counted, k, dense_ext_to, alpha, mass, dev, part_dev, local, n)
    return alpha, pr, mass, extro_mass, extroversion, ext_to


def extroversion_field(
    g: LabelledGraph,
    trie: TrieArrays,
    part: np.ndarray,
    k: int,
    depth_cap: Optional[int] = None,
    _precomputed: Optional[Dict] = None,
    dense_ext_to: bool = True,
    backend: Optional[str] = None,
    device: DeviceLike = None,
) -> ExtroversionResult:
    """Compute the extroversion field of ``part`` under the workload trie.

    ``depth_cap`` implements the paper's §5.2.2 time heuristic (stop VM row
    expansion at path length < t, trading accuracy for time).

    ``dense_ext_to=True`` (the default, matching ``TaperConfig``) also
    returns the dense ``(n, k)`` per-destination external-mass matrix.
    ``dense_ext_to=False`` selects the two-phase §Perf-T2 trade-off: the
    field skips the matrix and the swap engine derives each *candidate's*
    destination preferences lazily from its own cut edges.

    ``device`` defaults to ``"cuda"`` (raising if CUDA is absent); pass
    ``"cpu"`` to run on the CPU.  ``backend`` selects the DP engine:
    ``"cuda"`` (the ``vm_step`` kernel; the default on a CUDA device) or
    ``"torch"`` (the plain fused field; the default on the CPU).
    """
    device = resolve_device(device)
    if backend is None:
        backend = "cuda" if device.type == "cuda" else "torch"
    if backend not in FIELD_BACKENDS:
        raise ValueError(f"unknown field backend {backend!r}")
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(f"field backend 'cuda' needs a CUDA device, got {device}")
    depth_cap = depth_cap or trie.max_depth
    pre = _precomputed if _precomputed is not None else {}
    alpha, pr, mass, extro_mass, extroversion, ext_to = _field(
        g, trie, part, k, depth_cap, pre, dense_ext_to, backend, device)
    extro_mass = extro_mass.cpu().numpy()
    return ExtroversionResult(
        alpha=alpha.cpu().numpy(),
        pr=pr.cpu().numpy(),
        edge_mass=mass.cpu().numpy(),
        extro_mass=extro_mass,
        extroversion=extroversion.cpu().numpy(),
        ext_to=None if ext_to is None else ext_to.cpu().numpy(),
        total_extroversion=float(extro_mass.sum()),
    )


# ---------------------------------------------------------------------------
# Reference single-cell evaluation (paper §4.2) — used by tests/examples
# ---------------------------------------------------------------------------


def vm_cell(
    g: LabelledGraph, trie: TrieArrays, path_vertices, label_names=None
) -> np.ndarray:
    """``VM^(t)[p_1, ..., p_{t-1}, *]``: the distribution over next vertices
    given the path ``path_vertices`` (paper §4.2 worked example).

    Returns an ``(n,)`` vector of transition probabilities (rows need not sum
    to 1; the shortfall is the 'no subsequent traversal' mass, §4.2 fn. 6).
    """
    path = list(path_vertices)
    # find trie node for the label string of the path
    node = 0
    for v in path:
        child = trie.child_index[node, g.labels[v]]
        if child < 0:
            return np.zeros(g.n, dtype=np.float64)
        node = int(child)
    last = path[-1]
    nbrs = g.neighbors(last)
    nbr_labels = g.labels[nbrs]
    out = np.zeros(g.n, dtype=np.float64)
    for lab_id in range(trie.n_labels):
        child = trie.child_index[node, lab_id]
        if child < 0:
            continue
        cond = float(trie.cond_p[child])
        same = nbrs[nbr_labels == lab_id]
        if same.size:
            out[same] += cond / same.size
    return out
