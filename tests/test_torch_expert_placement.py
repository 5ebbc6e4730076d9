"""The port's TAPER expert placement (``core/expert_placement.py``) against
the JAX package's, in one process.

The co-routing graph's arrays are bitwise the reference's, the layer-flow
workload is the same queries at the same frequencies, and
``plan_expert_placement`` with the ``torch`` field (``device="cpu"``) gives
the reference's placement, cross-device mass, moves and iterations.  At
``benchmarks/expert_placement.py``'s setting (64 experts, 8 layers, top-4,
2,048 tokens, 8 devices, seed 0) the plan reproduces ``BENCH_PR10.json``'s
derived string; its trie holds one string per query, so its numbering does
not follow the string-hash seed."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from benchmarks import expert_placement as bench
from repro.core import expert_placement as R

from repro_torch.core import expert_placement as P

GRAPH_FIELDS = ("labels", "src", "dst", "row_ptr")


def _routing(seed, T=96, L=4, K=3, E=12):
    return np.random.default_rng(seed).integers(0, E, (T, L, K)), E


@pytest.mark.parametrize("seed", [0, 1])
def test_co_routing_graph_bitwise(seed):
    ids, E = _routing(seed)
    g, rg = P.co_routing_graph(ids, E), R.co_routing_graph(ids, E)
    assert (g.n, g.m, g.label_names) == (rg.n, rg.m, rg.label_names)
    for f in GRAPH_FIELDS:
        a, b = getattr(g, f), getattr(rg, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert g.n == ids.shape[1] * E


def test_layer_flow_workload_is_the_references():
    w, rw = P.layer_flow_workload(5), R.layer_flow_workload(5)
    assert [(q.to_text(), q.qhash, f) for q, f in w] == [
        (q.to_text(), q.qhash, f) for q, f in rw]
    assert [q.to_text() for q, _ in w] == ["L0.L1", "L1.L2", "L2.L3", "L3.L4"]
    assert P.layer_flow_workload(1) == []


def test_cross_device_mass_is_the_references():
    ids, E = _routing(2)
    g, rg = P.co_routing_graph(ids, E), R.co_routing_graph(ids, E)
    part = np.random.default_rng(3).integers(0, 4, g.n).astype(np.int32)
    assert P.cross_device_mass(g, part) == R.cross_device_mass(rg, part)
    assert P.cross_device_mass(g, np.zeros(g.n, np.int32)) == 0.0


def _same_plan(mine, ref):
    assert np.array_equal(mine["placement0"], ref["placement0"])
    assert np.array_equal(mine["placement"], ref["placement"])
    assert mine["placement"].dtype == ref["placement"].dtype
    for k in ("cross_mass_before", "cross_mass_after", "moves", "iterations"):
        assert mine[k] == ref[k], k


@pytest.mark.parametrize("seed,n_devices", [(4, 3), (5, 4)])
def test_plan_is_the_references(seed, n_devices):
    ids, E = _routing(seed, T=256, L=5, K=2, E=16)
    mine = P.plan_expert_placement(ids, E, n_devices, seed=seed, device="cpu")
    ref = R.plan_expert_placement(ids, E, n_devices, seed=seed)
    _same_plan(mine, ref)
    assert mine["cross_mass_after"] <= mine["cross_mass_before"]


def test_benchmark_setting_reproduces_bench_pr10():
    ids = bench.synth_routing()
    mine = P.plan_expert_placement(ids, bench.N_EXPERTS, bench.N_DEVICES, device="cpu")
    _same_plan(mine, R.plan_expert_placement(ids, bench.N_EXPERTS, bench.N_DEVICES))
    before, after = mine["cross_mass_before"], mine["cross_mass_after"]
    derived = (f"cross_device_coactivation before={before:.0f} after={after:.0f} "
               f"reduction={1 - after / max(before, 1e-9):.1%} "
               f"moves={mine['moves']} iters={mine['iterations']}")
    rows = json.loads((Path(__file__).parent.parent / "BENCH_PR10.json").read_text())["rows"]
    want = {r["name"]: r["derived"] for r in rows}["expert_placement/summary"]
    assert derived == want
    assert derived.endswith("before=199753 after=156865 reduction=21.5% moves=475 iters=4")
