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

The backends:

* ``"torch"`` — the plain fused field (the JAX package's ``field_fn_fused``):
  per depth, one batched gather / elementwise / segment-sum pass over all
  trie nodes of that depth.  The CPU path.
* ``"cuda"`` — the step runs as the hand-written ``vm_step`` kernel over the
  graph's dst-sorted CSR (the counterpart of the JAX package's
  ``_pallas_field``), as a chain of *delta* states: ``beta_d`` holds only
  the depth-``d`` trie columns, so one application of the full transition
  tensor per depth advances every state without double counting.  CUDA
  devices only; the default there.

* ``"cuda_sharded"`` / ``"torch_sharded"`` — the same recurrence per shard
  of a ``torch.distributed`` process group (the counterpart of the JAX
  package's ``"pallas_sharded"``), the kernel or the plain step once per
  shard and depth.  Every rank builds the graph's sharded packing
  (``LabelledGraph.vm_packing_sharded``, dealt along a shard map — see
  ``repro_torch.graphs.sharded_packing``) on the host, uploads only its own
  shard's slices, and between depths exchanges the ``beta`` rows other
  shards read: ``halo_exchange="sliced"`` (default) one ``all_reduce`` of
  the small hot union and ``S - 1`` ring rounds of per-pair slices, each
  padded to its round's ``round_cap`` (``batch_isend_irecv``), or
  ``"psum"`` one ``all_reduce`` of the union frontier.  A shard advances
  its rows over ``[own rows | exchanged rows]`` (``vm_step`` with a
  halo-extended input); at the end ``alpha`` and the per-slot masses are
  all-gathered, and every rank computes the aggregates.  The group is
  ``_precomputed["_group"]``, else ``repro_torch.launch.mesh.make_smoke_group``.

All backends round every product and add every sum in the order of the
reference's fused ``jnp`` field: each per-edge message is
``((alpha * cond_p) * inv_cnt) * local``; per-edge masses sum a depth's
trie columns left to right (where all of a depth's nodes share a label,
each message after the first as one fused multiply-add, as the JAX
package's compiled field adds them on the CPU: ``_depth_mass``); every
segment sum runs over contiguous,
pre-sorted runs, each summed in edge order from 0 — the order of a
sequential scatter-add (``torch.segment_reduce`` on 2-D values, no
atomics).  So the field repeats bitwise from run to run, on any device.
The sharded backends give the single-device field's bits too: a halo row
has one owner (the ``all_reduce`` adds zeros to it, ring payloads are
copies), a shard's edges reach each destination in the global CSR's
order (ascending source), and the parent columns a depth reads in
``beta`` are the floats cumulative ``alpha`` holds.
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.tpstry import TrieArrays
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs.graph import LabelledGraph
from repro_torch.kernels.segment_spmm.ops import EdgeCSR, csr_offsets
from repro_torch.kernels.segment_spmm.ref import segment_sum
from repro_torch.kernels.vm_step.ops import vm_step
from repro_torch.kernels.vm_step.ref import transition_columns, vm_step_reference
from repro_torch.obs.registry import default_registry
from repro_torch.obs.trace import NOOP_SPAN

_EPS = 1e-30

#: fields computed and the bytes of their outputs read back to the host
_EVALUATIONS = default_registry().counter("field_evaluations_total")
_READBACK_BYTES = default_registry().counter("field_readback_bytes_total")

#: the port's field backends: the CUDA kernel and the plain torch field on
#: one device, and each of them per shard of a process group
FIELD_BACKENDS = ("cuda", "torch", "cuda_sharded", "torch_sharded")
SHARDED_BACKENDS = ("cuda_sharded", "torch_sharded")
#: the sharded backends' per-depth exchanges (the JAX package's names)
HALO_EXCHANGES = ("sliced", "psum")


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


def _put(a, dtype, device):
    return torch.as_tensor(np.asarray(a), device=device).to(dtype)


def _device_inputs(g: LabelledGraph, pre: Dict, cnt, lab_vcount,
                   device: torch.device, with_csr: bool = True) -> Dict:
    """Device-resident copies of the partition-independent field inputs.

    Cached inside the caller's ``_precomputed`` dict (Taper keeps one per
    graph) next to the graph's ``version`` and the device, so repeated
    iterations re-use the same buffers: only the partition vector crosses
    host->device per iteration.  After a mutation the stale version's
    buffers are dropped before the new ones are uploaded (with the CSR's
    new row plan), so one version's buffers are held at a time.  The
    graph's dst-sorted CSR is added on the first call that needs it
    (``with_csr``); the sharded backends read their shards' CSRs instead."""
    key = (g.version, device)
    dev = pre.get("_dev")
    if dev is None or pre.get("_dev_key") != key:
        pre["_dev"] = dev = None      # free the stale version's buffers first
        dev = {
            "src": _put(g.src, torch.int64, device),
            "dst": _put(g.dst, torch.int64, device),
            "labels": _put(g.labels, torch.int64, device),
            "labels_i32": _put(g.labels, torch.int32, device),
            # float32 division on the device, as the reference field does
            "inv_cnt": 1.0 / torch.clamp_min(_put(cnt, torch.float32, device), 1.0),
            "lab_vcount": _put(lab_vcount, torch.int64, device),
            "out_deg": _put(np.diff(g.row_ptr), torch.int64, device),
        }
        dev["dst_lab"] = dev["labels"][dev["dst"]]
        pre["_dev"] = dev
        pre["_dev_key"] = key
    if with_csr and "csr" not in dev:
        csr = g.vm_csr()
        # checked and row-planned once per graph version, when the graph made it
        dev["csr"] = csr.to(device)
        dev["in_deg"] = _put(np.diff(csr.row_ptr), torch.int64, device)
        # per CSR slot: 1 / cnt[src, label(dst)], gathered from the same table
        dev["csr_inv_cnt"] = dev["inv_cnt"][dev["src"], dev["dst_lab"]][dev["csr"].order]
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


def _transition_dev(trie: TrieArrays, depth_cap: int, pre: Dict,
                    device: torch.device):
    """Device-resident column form ``(par, val)`` of the transition,
    re-uploaded only when the trie probabilities (or depth cap) change —
    not per iteration."""
    T_key = (trie.topology_signature(), int(depth_cap),
             trie.cond_p.tobytes(), device)
    t_hit = pre.get("_T_dev")
    if t_hit is None or t_hit[0] != T_key:
        t_hit = (T_key, tuple(torch.as_tensor(a, device=device)
                              for a in _capped_transition(trie, depth_cap)))
        pre["_T_dev"] = t_hit
    return t_hit[1]


def _depth_nodes(trie: TrieArrays, max_depth: int) -> List[List[int]]:
    """Trie nodes of each depth 2..max_depth (compile() sorts by depth)."""
    return [[c for c in range(trie.n_nodes) if trie.depth[c] == d]
            for d in range(2, max_depth + 1)]


def _depth_contrib(alpha, nodes_d, trie, cond_p, src, dst_lab, inv_cnt):
    """(E, n_d) per-edge messages of one depth:
    ``((alpha[src, parent(c)] * cond_p(c)) * inv_cnt[src, l(c)]) * [l(dst) == l(c)]``.

    ``inv_cnt`` is the ``(n, L)`` table, indexed by ``src``, or ``(E,)``,
    each edge's own ``1 / cnt[src, l(dst)]``.  The two give the same bits:
    they differ only in columns with ``l(c) != l(dst)``, which the mask
    multiplies by 0 (every factor is finite and nonnegative)."""
    device = alpha.device
    pars = torch.as_tensor(trie.parent[nodes_d].astype(np.int64), device=device)
    labs = torch.as_tensor(trie.label[nodes_d].astype(np.int64), device=device)
    cols = torch.as_tensor(np.asarray(nodes_d, np.int64), device=device)
    a_par = alpha[:, pars][src]
    coef = cond_p[cols][None, :]
    ic = inv_cnt[:, labs][src] if inv_cnt.dim() == 2 else inv_cnt[:, None]
    lab_mask = (dst_lab[:, None] == labs[None, :]).to(torch.float32)
    return a_par * coef * ic * lab_mask


def _row_sum(contrib: torch.Tensor) -> torch.Tensor:
    """Sum of the columns of ``contrib``, left to right."""
    out = contrib[:, 0]
    for j in range(1, contrib.shape[1]):
        out = out + contrib[:, j]
    return out


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 tensors rounded once to float32, on any
    device: the product is exact in float64, the sum is rounded to float64
    with its error kept (TwoSum), and where that rounding left the sum
    exactly halfway between two floats (the low 29 bits of its float64
    fraction ``1 << 28``) the error decides the side.  Exact while the
    result is a normal float32."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    half = (s.view(torch.int64) & ((1 << 29) - 1)) == (1 << 28)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where(half & (err != 0), torch.nextafter(s, toward), s)
    return s.float()


def _depth_mass(contrib, alpha, nodes_d, trie, cond_p, src, dst_lab, inv_cnt):
    """Per-edge mass of one depth: the sum of its messages ``contrib``
    (``_depth_contrib``), left to right.  Where every trie node of the
    depth has the same label (and there are two or more), each message
    after the first is added as one fused multiply-add of its factors
    ``alpha[src, parent(c)] * cond_p(c)`` and ``1 / cnt[src, l(c)]``: the JAX
    package's ``jnp`` field on the CPU, whose compiler turns the label mask
    into one row predicate outside the row sum and contracts each product
    into the sum."""
    labs = trie.label[nodes_d]
    if len(nodes_d) < 2 or (labs != labs[0]).any():
        return _row_sum(contrib)
    lab = int(labs[0])
    ic = inv_cnt[src, lab] if inv_cnt.dim() == 2 else inv_cnt
    live = dst_lab == lab
    out = contrib[:, 0]
    for c in nodes_d[1:]:
        p = alpha[:, int(trie.parent[c])][src] * cond_p[c]
        out = torch.where(live, _fma32(p, ic, out), out)
    return out


def _field(g: LabelledGraph, trie: TrieArrays, part: np.ndarray, k: int,
           depth_cap: int, pre: Dict, dense_ext_to: bool, backend: str,
           device: torch.device, span=NOOP_SPAN):
    n, m, N = g.n, g.m, trie.n_nodes
    with span.child("field.inputs"):
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
            par, val = _transition_dev(trie, depth_cap, pre, device)
            # local-edge weights in CSR order (local is 0/1, so exact)
            w = dev["csr_inv_cnt"] * local[dev["csr"].order]
            beta = alpha

        mass = torch.zeros(m, dtype=torch.float32, device=device)
    for d, nodes_d in enumerate(_depth_nodes(trie, max_depth), start=1):
        if not nodes_d:
            break
        with span.child("field.depth", depth=d):
            contrib = _depth_contrib(alpha, nodes_d, trie, cond_p, dev["src"],
                                     dev["dst_lab"], dev["inv_cnt"])
            # per-edge mass of the depth step over ALL edges (cut + local)
            mass = mass + _depth_mass(contrib, alpha, nodes_d, trie, cond_p, dev["src"],
                                      dev["dst_lab"], dev["inv_cnt"])
            if backend == "cuda":
                # the DP itself advances over local edges only — vm_step kernel
                beta = vm_step(beta, par, val, dev["csr"], w, dev["labels_i32"])
                alpha = alpha + beta
            else:
                upd = segment_sum((contrib * local[:, None])[dev["csr"].order],
                                  dev["in_deg"])
                cols = torch.as_tensor(np.asarray(nodes_d, np.int64), device=device)
                alpha[:, cols] += upd

    with span.child("field.aggregates"):
        counted = [
            i for i in range(N)
            if 1 <= int(trie.depth[i]) < max_depth and not bool(trie.is_leaf[i])
        ]
        pr, extro_mass, extroversion, ext_to = _field_aggregates(
            counted, k, dense_ext_to, alpha, mass, dev, part_dev, local, n)
    return alpha, pr, mass, extro_mass, extroversion, ext_to


def field_from_arrays(trie: TrieArrays, k: int, src, dst, labels, cnt, lab_vcount,
                      part, p, cond_p, *, n: int, m: int, backend: str = "torch",
                      dense_ext_to: bool = False):
    """The field of one partitioning from its arrays, on their device: the
    counterpart of the JAX package's ``_build_field_fn`` function, which a
    cell plan runs as its step (``launch/specs.py``).

    ``src``, ``dst`` (m,) are the edge list in any order, ``labels`` and
    ``part`` (n,), ``cnt`` (n, L) the neighbour label counts,
    ``lab_vcount`` (L,) the label vertex counts, ``p`` and ``cond_p`` (N,)
    the trie's probabilities (its topology is fixed by ``trie``).  Returns
    ``(alpha, pr, mass, extro_mass, extroversion)``, with ``ext_to`` (n, k)
    after them under ``dense_ext_to``.  Every intermediate has a shape that
    ``n``, ``m`` and the trie fix (the CSRs by a stable sort and
    :func:`csr_offsets`), so the step also runs on fake tensors.  ``cnt``
    is read only at each edge's ``(src, label(dst))``.  ``backend`` is
    ``"cuda"`` (the ``vm_step`` kernel: CUDA tensors launch it, CPU
    tensors its plain version) or ``"torch"`` (the plain fused step); on a
    graph's own arrays (edges sorted by source) the result is bitwise
    :func:`_field`'s with the same backend."""
    if backend not in ("cuda", "torch"):
        raise ValueError(f"field_from_arrays: backend must be 'cuda' or 'torch', got {backend!r}")
    device, N, max_depth = src.device, trie.n_nodes, trie.max_depth
    src, dst, labels64 = src.long(), dst.long(), labels.long()
    dst_lab = labels64[dst]
    inv_cnt = 1.0 / torch.clamp_min(cnt[src, dst_lab].to(torch.float32), 1.0)
    local = (part[src] == part[dst]).to(torch.float32)
    alpha = _prior_columns(trie.depth, trie.label, N, labels64, lab_vcount.long(), p, n)
    order = torch.argsort(dst, stable=True)
    row_ptr = csr_offsets(dst[order], n)
    if backend == "cuda":
        csr = EdgeCSR(row_ptr=row_ptr, src=src[order].to(torch.int32), order=order)
        # the transition's column form (``transition_columns``) with the
        # probabilities ``cond_p`` given on the device
        c = np.nonzero(trie.parent >= 0)[0]
        rows = torch.as_tensor(trie.label[c], device=device).long()
        cols = torch.as_tensor(c, device=device)
        par = torch.zeros((trie.n_labels, N), dtype=torch.int32, device=device)
        par[rows, cols] = torch.as_tensor(trie.parent[c], dtype=torch.int32, device=device)
        val = torch.zeros((trie.n_labels, N), dtype=torch.float32, device=device)
        val[rows, cols] = cond_p[cols]
        w = inv_cnt[order] * local[order]
        labels_i32 = labels.to(torch.int32)
        beta = alpha
    else:
        in_deg = (row_ptr[1:] - row_ptr[:-1]).long()

    mass = torch.zeros(m, dtype=torch.float32, device=device)
    for nodes_d in _depth_nodes(trie, max_depth):
        if not nodes_d:
            break
        contrib = _depth_contrib(alpha, nodes_d, trie, cond_p, src, dst_lab, inv_cnt)
        mass = mass + _depth_mass(contrib, alpha, nodes_d, trie, cond_p, src,
                                  dst_lab, inv_cnt)
        if backend == "cuda":
            beta = vm_step(beta, par, val, csr, w, labels_i32)
            alpha = alpha + beta
        else:
            upd = segment_sum((contrib * local[:, None])[order], in_deg)
            cols = torch.as_tensor(np.asarray(nodes_d, np.int64), device=device)
            alpha[:, cols] += upd

    pr = torch.zeros(n, dtype=torch.float32, device=device)
    for i in range(N):
        if 1 <= int(trie.depth[i]) < max_depth and not bool(trie.is_leaf[i]):
            pr = pr + alpha[:, i]
    ext_mass = mass * (1.0 - local)
    by_src = torch.argsort(src, stable=True)
    out_ptr = csr_offsets(src[by_src], n)
    extro_mass = segment_sum(ext_mass[by_src], (out_ptr[1:] - out_ptr[:-1]).long())
    extroversion = torch.where(pr > _EPS, extro_mass / torch.clamp_min(pr, _EPS), 0.0)
    out = (alpha, pr, mass, extro_mass, extroversion)
    if dense_ext_to:
        key = src * k + part[dst].long()
        by_key = torch.argsort(key, stable=True)
        key_ptr = csr_offsets(key[by_key], n * k)
        ext_to = segment_sum(ext_mass[by_key], (key_ptr[1:] - key_ptr[:-1]).long())
        out += (ext_to.reshape(n, k),)
    return out


def _upload_shard(sp, s: int, device: torch.device, halo_exchange: str,
                  plain: bool) -> Dict:
    """Shard ``s``'s device inputs for one exchange: its CSR (with its row
    plan), its per-slot channels in CSR order, and, for the plain step
    (``plain``), each CSR entry's destination row."""
    from repro_torch.kernels.segment_spmm.ops import csr_from_shard

    csr = csr_from_shard(sp, s, halo_exchange).to(device)
    slots = csr.order
    vlabels = _put(sp.vlabels[s], torch.int64, device)
    shard = {
        "kind": (halo_exchange, plain),
        "csr": csr,
        "slots": slots,
        "inv_cnt": _put(sp.inv_cnt[s], torch.float32, device)[slots],
        "src_global": _put(sp.src_global[s], torch.int64, device)[slots],
        "dst_global": _put(sp.dst_global[s], torch.int64, device)[slots],
        "dst_label": _put(sp.dst_label[s], torch.int64, device)[slots],
        "vlabels": vlabels,
        # rows past the graph (-1) have no edges; the kernel wants a label
        "row_label": torch.clamp_min(vlabels, 0).to(torch.int32),
        "send_local": _put(sp.send_local[s], torch.int64, device),
    }
    if plain:
        shard["rows"] = torch.repeat_interleave(
            torch.arange(sp.n_local_pad, device=device),
            (csr.row_ptr[1:] - csr.row_ptr[:-1]).long())
    return shard


def _sharded_device_arrays(sp, pre: Dict, rank: int, device: torch.device,
                           halo_exchange: str, plain: bool) -> Dict:
    """This rank's device-resident shard inputs, re-uploaded per dirty shard.

    Every rank holds the whole packing on the host and uploads only its own
    shard's slices for the exchange and step in use (``_upload_shard``;
    uploaded again, uncounted, when a caller switches them) and owner rows
    of the exchange tables.  The packing's ``shard_epoch`` counters say which shard slices
    changed since this cache uploaded them: this rank re-uploads its slices
    when its own shard's epoch moved, and the frontier's owner rows when
    ``fr_epoch`` moved (the hot tier changes only with a rebuild).  Old
    buffers are dropped before new ones are uploaded.  ``pre["_shard_uploads"]``
    counts shards as the JAX package does: every dirty shard of the group,
    and all ``S`` on a rebuild."""
    stats = pre.setdefault(
        "_shard_uploads", {"last_shards": 0, "total_shards": 0, "rebuilds": 0})
    sdev = pre.get("_shard_dev")
    if sdev is not None and (sdev["sp"] is not sp or sdev["key"] != (rank, device)):
        sdev = None  # packing rebuilt from scratch (capacity overflow, re-deal)
    if sdev is None:
        pre["_shard_dev"] = None
        sdev = {"sp": sp, "key": (rank, device),
                "epochs": sp.shard_epoch.copy(), "fr_epoch": sp.fr_epoch,
                "shard": _upload_shard(sp, rank, device, halo_exchange, plain),
                "fr": (_put(sp.fr_local_idx[rank], torch.int64, device),
                       _put(sp.fr_owned[rank], torch.float32, device)),
                "hot": (_put(sp.hot_local_idx[rank], torch.int64, device),
                        _put(sp.hot_owned[rank], torch.float32, device)),
                "n_pos": sp.pos_of.shape[0],
                "pos": None if sp.identity else _put(sp.pos_of, torch.int64, device)}
        pre["_shard_dev"] = sdev
        stats["last_shards"] = sp.n_shards
        stats["total_shards"] += sp.n_shards
        stats["rebuilds"] += 1
        return sdev
    dirty = np.nonzero(sp.shard_epoch != sdev["epochs"])[0]
    if rank in dirty or sdev["shard"]["kind"] != (halo_exchange, plain):
        sdev["shard"] = None
        sdev["shard"] = _upload_shard(sp, rank, device, halo_exchange, plain)
    if sp.fr_epoch != sdev["fr_epoch"]:
        sdev["fr"] = None
        sdev["fr"] = (_put(sp.fr_local_idx[rank], torch.int64, device),
                      _put(sp.fr_owned[rank], torch.float32, device))
        sdev["fr_epoch"] = sp.fr_epoch
    if sp.pos_of.shape[0] != sdev["n_pos"]:
        # vertex growth extended the shard map's identity tail
        sdev["n_pos"] = sp.pos_of.shape[0]
        sdev["pos"] = None if sp.identity else _put(sp.pos_of, torch.int64, device)
    sdev["epochs"] = sp.shard_epoch.copy()
    stats["last_shards"] = int(dirty.size)
    stats["total_shards"] += int(dirty.size)
    return sdev


def _check_spmd(transport, g: LabelledGraph, trie: TrieArrays, part) -> None:
    """Raise unless every rank evaluates the same graph version, trie and
    partition: the ranks run the invocation in full (SPMD), and a rank
    whose host swap diverged would corrupt the others' halos."""
    h = hashlib.blake2b(digest_size=8)
    for a in (np.asarray([g.version, g.n, g.m], np.int64), trie.cond_p,
              np.asarray(part, np.int32)):
        h.update(np.ascontiguousarray(a).tobytes())
    mine = torch.tensor([int.from_bytes(h.digest(), "little", signed=True)],
                        dtype=torch.int64, device=transport.device)
    seen = transport.all_gather(mine, key="spmd").reshape(-1).cpu()
    if not bool((seen == seen[0]).all()):
        raise RuntimeError(f"sharded field: the ranks hold different graphs, "
                           f"tries or partitions ({seen.tolist()})")


def _exchange(beta, sdev, transport, halo_exchange: str, round_cap):
    """The rows of ``beta`` other shards read, in the layout of this
    shard's source map: the union frontier (``"psum"``), or the hot union
    and then the ring rounds' slices (``"sliced"``)."""
    if halo_exchange == "psum":
        # each frontier row has exactly one owner: the sum adds only zeros
        idx, own = sdev["fr"]
        return transport.all_reduce(beta[idx] * own[:, None], key="psum")
    idx, own = sdev["hot"]
    hot = transport.all_reduce(beta[idx] * own[:, None], key="hot")
    S, me = transport.size, transport.rank
    send = sdev["shard"]["send_local"]
    # round r: this shard's slice for the reader r ahead, padded to round_cap[r]
    payloads = [beta[send[(me + r) % S, :round_cap[r]]] for r in range(1, S)]
    return torch.cat([hot] + transport.ring(payloads))


def _sharded_field(g: LabelledGraph, trie: TrieArrays, part: np.ndarray,
                   k: int, depth_cap: int, pre: Dict, dense_ext_to: bool,
                   backend: str, device: torch.device,
                   shard_map_source: str, halo_exchange: str, span=NOOP_SPAN):
    """The field over this rank's shard of the group; returns the whole
    field on every rank (module docstring).

    The shard map is sticky, as in the JAX package: the first evaluation
    resolves ``shard_map_source`` into a vertex permutation cached in
    ``pre["_shard_order"]`` (``(token, pos_of)``), reused until
    ``Taper.maybe_redeal_shards`` replaces it; callers may seed it."""
    from repro_torch.graphs.sharded_packing import compute_shard_order
    from repro_torch.launch.mesh import Transport, make_smoke_group

    with span.child("field.inputs"):
        group = pre.get("_group")
        if group is None:
            group = pre["_group"] = make_smoke_group(device)
        transport = pre.get("_transport")
        if transport is None or transport.group is not group or transport.device != device:
            transport = pre["_transport"] = Transport(group, device)
        # a caller's poll before each collective (serve/sharded.py::run_agreed)
        transport.before = pre.get("_before_collective")
        S, rank = transport.size, transport.rank

        n, m, N = g.n, g.m, trie.n_nodes
        cnt = pre.get("cnt")
        if cnt is None:
            # the graph's own (incrementally patched) matrix, so the cached
            # sharded packing stays patchable across mutations
            cnt = g.cached_neighbor_label_counts()
        lab_vcount = pre.get("lab_vcount")
        if lab_vcount is None:
            lab_vcount = g.label_counts()
        dev = _device_inputs(g, pre, cnt, lab_vcount, device, with_csr=False)
        if S > 1:
            _check_spmd(transport, g, trie, part)

        order_entry = pre.get("_shard_order")
        if order_entry is None and shard_map_source != "stripe":
            order_entry = (f"{shard_map_source}:0",
                           compute_shard_order(g, shard_map_source, S, part=part))
            pre["_shard_order"] = order_entry
        token, order = order_entry if order_entry is not None else ("stripe", None)
        sp = g.vm_packing_sharded(S, cnt=cnt, order=order, order_token=token)
        sdev = _sharded_device_arrays(sp, pre, rank, device, halo_exchange,
                                      plain=backend != "cuda_sharded")
        shard = sdev["shard"]
        csr = shard["csr"]
        round_cap = [int(c) for c in sp.round_cap]

        part_dev = torch.as_tensor(np.asarray(part, np.int64), device=device)
        cond_p = torch.as_tensor(trie.cond_p, device=device)
        par, val = _transition_dev(trie, depth_cap, pre, device)
        # this shard's local-edge weights in CSR order (local is 0/1, so exact)
        w = shard["inv_cnt"] * (part_dev[shard["src_global"]]
                                == part_dev[shard["dst_global"]]).to(torch.float32)
        alpha = _prior_columns(trie.depth, trie.label, N, shard["vlabels"],
                               dev["lab_vcount"], torch.as_tensor(trie.p, device=device),
                               sp.n_local_pad)
        beta = alpha
        slot_mass = torch.zeros(w.shape[0], dtype=torch.float32, device=device)
        max_depth = min(trie.max_depth, depth_cap)
        # bytes each shard receives a depth step (the halo exchange)
        halo = sp.halo_bytes_per_depth(N, exchange=halo_exchange)
    exchange_s = 0.0
    for d, nodes_d in enumerate(_depth_nodes(trie, max_depth), start=1):
        if not nodes_d:
            break
        with span.child("field.depth", depth=d, halo_bytes=halo):
            t0 = time.perf_counter()
            a_in = torch.cat([beta, _exchange(beta, sdev, transport, halo_exchange,
                                              round_cap)])
            exchange_s += time.perf_counter() - t0
            # per-slot mass of the depth step over ALL edges (cut + local)
            src = csr.src.long()
            contrib = _depth_contrib(a_in, nodes_d, trie, cond_p, src, shard["dst_label"],
                                     shard["inv_cnt"])
            slot_mass = slot_mass + _depth_mass(contrib, a_in, nodes_d, trie, cond_p, src,
                                                shard["dst_label"], shard["inv_cnt"])
            del contrib
            # the DP advances over local edges only: the kernel, or the plain step
            if backend == "cuda_sharded":
                beta = vm_step(a_in, par, val, csr, w, shard["row_label"])
            else:
                beta = vm_step_reference(a_in, par, val, csr.src, shard["rows"], w,
                                         shard["row_label"][shard["rows"]],
                                         sp.n_local_pad)
            alpha = alpha + beta

    with span.child("field.aggregates"):
        # every shard's rows and slot masses on every rank; positions back
        # to vertex order (a slice under the identity stripe map)
        t0 = time.perf_counter()
        alpha_pos = transport.all_gather(alpha, key="alpha").reshape(-1, N)
        slots = torch.zeros(sp.e_pad, dtype=torch.float32, device=device)
        slots[shard["slots"]] = slot_mass
        slot_all = transport.all_gather(slots, key="mass").cpu().numpy()
        exchange_s += time.perf_counter() - t0
        alpha = alpha_pos[:n] if sdev["pos"] is None else alpha_pos[sdev["pos"]]
        mass = torch.as_tensor(sp.scatter_slot_values(slot_all, m), device=device)
        local = (part_dev[dev["src"]] == part_dev[dev["dst"]]).to(torch.float32)

        full = sp.full_field_bytes_per_depth(n, N)
        pre["_halo_stats"] = {
            "halo_bytes_per_depth": halo,
            "full_field_bytes_per_depth": full,
            "halo_ratio": halo / max(full, 1),
            "shard_map_source": token.split(":")[0],
            "halo_exchange": halo_exchange,
            "n_shards": S,
            "n_frontier": sp.n_frontier,
            "hot_rows": sp.hot_pad,
            "sliced_rows": sp.hot_pad + int(sp.round_cap[1:].sum()),
            # DP depth steps (each one is a halo exchange)
            "depth_steps": max(int(max_depth) - 1, 0),
        }
        # host seconds of the exchanges and the final gathers (gloo on CUDA
        # waits for the device at each staging copy; NCCL is asynchronous,
        # so there this is the time to enqueue)
        pre["_shard_exchange"] = {"transport": transport.name, "seconds": exchange_s}

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
    shard_map_source: str = "stripe",
    halo_exchange: str = "sliced",
    span=NOOP_SPAN,
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
    ``"cuda"`` (the ``vm_step`` kernel; the default on a CUDA device),
    ``"torch"`` (the plain fused field; the default on the CPU), or
    ``"cuda_sharded"`` / ``"torch_sharded"`` (the kernel / the plain step
    once per shard of a process group, halo-exchanging the cross-shard
    ``beta`` rows between depths — see the module docstring; seed
    ``_precomputed["_group"]`` to pin a group).  ``shard_map_source`` /
    ``halo_exchange`` apply to the sharded backends only: how vertices are
    dealt to shards (``"stripe"`` | ``"partition"`` | ``"bfs"``) and whether
    the exchange moves the hot union and per-shard-pair ring slices
    (``"sliced"``) or the union frontier (``"psum"``).

    ``span`` (an ``obs.trace`` span; ``Taper.field`` passes its
    ``invocation.field``) parents the evaluation's spans: ``field.inputs``,
    ``field.depth`` (``depth=d`` for the d-th DP depth step; under the
    sharded backends also its ``halo_bytes``, the exchange inside it),
    ``field.aggregates`` and ``field.readback`` (``bytes=`` read back).
    Each evaluation adds 1 to ``field_evaluations_total`` and its outputs'
    bytes to ``field_readback_bytes_total`` (``obs.default_registry()``).
    """
    device = resolve_device(device)
    if backend is None:
        backend = "cuda" if device.type == "cuda" else "torch"
    if backend not in FIELD_BACKENDS:
        raise ValueError(f"unknown field backend {backend!r}")
    if backend in ("cuda", "cuda_sharded") and device.type != "cuda":
        raise ValueError(f"field backend {backend!r} needs a CUDA device, got {device}")
    if halo_exchange not in HALO_EXCHANGES:
        raise ValueError(f"unknown halo exchange {halo_exchange!r}")
    depth_cap = depth_cap or trie.max_depth
    pre = _precomputed if _precomputed is not None else {}
    if backend in SHARDED_BACKENDS:
        out = _sharded_field(g, trie, part, k, depth_cap, pre, dense_ext_to,
                             backend, device, shard_map_source, halo_exchange,
                             span)
    else:
        out = _field(g, trie, part, k, depth_cap, pre, dense_ext_to, backend,
                     device, span)
    alpha, pr, mass, extro_mass, extroversion, ext_to = out
    with span.child("field.readback") as rb:
        extro_mass = extro_mass.cpu().numpy()
        fld = ExtroversionResult(
            alpha=alpha.cpu().numpy(),
            pr=pr.cpu().numpy(),
            edge_mass=mass.cpu().numpy(),
            extro_mass=extro_mass,
            extroversion=extroversion.cpu().numpy(),
            ext_to=None if ext_to is None else ext_to.cpu().numpy(),
            total_extroversion=float(extro_mass.sum()),
        )
        nbytes = sum(a.nbytes for a in (fld.alpha, fld.pr, fld.edge_mass, fld.extro_mass,
                                        fld.extroversion, fld.ext_to) if a is not None)
        rb.set(bytes=nbytes)
    _EVALUATIONS.inc()
    _READBACK_BYTES.inc(nbytes)
    return fld


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
