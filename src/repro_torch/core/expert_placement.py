"""TAPER-style MoE expert placement.

Tokens flow expert-to-expert across consecutive MoE layers; when two
experts that frequently co-serve the same tokens sit on different devices,
the all-to-all between those layers carries that token twice across the
interconnect.  The expert *co-routing* graph (vertices = (layer, expert),
labels = layer ids, edges weighted by co-routing counts) is exactly a
heterogeneous labelled graph with a 2-step path workload
``layer_l . layer_{l+1}`` — so TAPER applies unchanged.

``plan_expert_placement`` builds the graph from routing statistics and runs
a TAPER invocation on a hash placement, its field on ``device`` (default
``"cuda"``: the ``vm_step`` kernel; ``"cpu"``: the plain ``torch`` field),
and reports the reduction in cross-device co-routing mass (the all-to-all
skew proxy).  Host arrays are numpy, bitwise the JAX package's.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.rpq import concat, label
from repro_torch.core.taper import Taper, TaperConfig
from repro_torch.device import DeviceLike
from repro_torch.graphs.graph import LabelledGraph
from repro_torch.graphs.partition import hash_partition


def co_routing_graph(expert_ids: np.ndarray, n_experts: int) -> LabelledGraph:
    """expert_ids: (T, L, K) — per token, per MoE layer, the routed experts.

    Vertex (l, e) has label "L<l>"; an edge connects (l, e) to (l+1, e')
    whenever some token is routed to e at layer l and e' at layer l+1.
    """
    T, L, K = expert_ids.shape
    edges = []
    for l in range(L - 1):
        a = expert_ids[:, l, :]          # (T, K)
        b = expert_ids[:, l + 1, :]
        for i in range(K):
            for j in range(K):
                u = l * n_experts + a[:, i]
                v = (l + 1) * n_experts + b[:, j]
                edges.append(np.stack([u, v], axis=1))
    edges = np.concatenate(edges, axis=0)
    labels = np.repeat(np.arange(L), n_experts).astype(np.int32)
    return LabelledGraph.from_undirected_edges(
        L * n_experts, labels, edges, [f"L{l}" for l in range(L)],
        dedup=False,
    )


def layer_flow_workload(n_layers: int):
    """RPQ workload: one 2-step pattern per consecutive layer pair."""
    qs = [concat(label(f"L{l}"), label(f"L{l + 1}")) for l in range(n_layers - 1)]
    f = 1.0 / max(len(qs), 1)
    return [(q, f) for q in qs]


def cross_device_mass(g: LabelledGraph, part: np.ndarray) -> float:
    """Co-routing edge mass crossing devices (all-to-all skew proxy)."""
    return float((part[g.src] != part[g.dst]).sum()) / 2.0


def plan_expert_placement(
    expert_ids: np.ndarray, n_experts: int, n_devices: int,
    seed: int = 0, max_iterations: int = 6, device: DeviceLike = None,
) -> Dict:
    """Place the experts of ``expert_ids`` (T, L, K) on ``n_devices`` by one
    TAPER invocation from a hash placement, its field on ``device``."""
    g = co_routing_graph(expert_ids, n_experts)
    L = expert_ids.shape[1]
    workload = layer_flow_workload(L)
    part0 = hash_partition(g.n, n_devices, seed)
    taper = Taper(g, n_devices, TaperConfig(
        max_iterations=max_iterations, balance_eps=0.1, seed=seed),
        device=device)
    report = taper.invoke(part0, workload)
    return {
        "graph": g,
        "placement0": part0,
        "placement": report.final_part,
        "cross_mass_before": cross_device_mass(g, part0),
        "cross_mass_after": cross_device_mass(g, report.final_part),
        "moves": report.total_moves,
        "iterations": report.iterations,
    }
