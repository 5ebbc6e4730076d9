"""CPU tests of the readers of the program's own spans and counters.

    PYTHONPATH=src python -m pytest -q portbench/tests

``field.host_ms`` reads the card's idle time inside the program's
``field.key`` and ``invocation.field`` ranges of a trace; ``field.readback_mb``,
``vm_step.launches``, ``setup.edges_s`` and ``setup.csr_s`` read the
program's process registry (``repro_torch.obs.default_registry()``), and
read nothing from a program that keeps none.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import cell, registry  # noqa: E402
from portbench import devtrace as tr  # noqa: E402

COUNTED = ["field.readback_mb", "vm_step.launches", "setup.edges_s", "setup.csr_s"]


def _record(trace=None):
    return cell.RunRecord(setup_s=1.0, graph_s=1.0, eval_s=[0.1, 0.1], window_s=0.2,
                          peak_bytes=0, peaks=None, trace=trace)


def _trace(host_ops, ops):
    spans = {tr.WINDOW: [(0, 10_000)], tr.DRAW: [], tr.FIELD: [(100, 4_900), (5_000, 9_900)]}
    return tr.Trace(window=(0, 10_000), spans=spans,
                    ops=[tr.DeviceOp(f"k{i}", "kernel", a, b) for i, (a, b) in enumerate(ops)],
                    host_ops=sorted(host_ops))


def test_field_host_ms_counts_idle_time_inside_the_programs_ranges_only():
    read = registry.reader("field.host_ms")
    host = [(200, 900, "field.key"), (1_000, 4_200, "invocation.field"),
            (5_100, 5_300, "field.key"), (5_400, 9_200, "invocation.field")]
    # busy 1,000-3,000 and 6,000-9,000, and 150-250 straddling the first key's start
    ops = [(1_000, 2_000), (1_500, 3_000), (150, 250), (6_000, 9_000)]
    trace = _trace(host, ops)
    # keys 700 less 50 busy and 200; roots 3,200 less 2,000 and 3,800 less 3,000
    assert read(_record(trace)) == pytest.approx((650 + 1_200 + 200 + 800) / 2 / 1e6)
    # idle time outside the ranges (the draws, the harness) is not counted
    assert read(_record(_trace(host, ops + [(9_300, 9_800)]))) == read(_record(trace))
    # memo hits (a key and no evaluation) alone: nothing to divide by
    assert read(_record(_trace([(300, 700, "field.key")], ops))) is None
    assert read(_record(_trace(host, []))) is None
    assert read(_record(None)) is None


def test_idle_gaps_are_named_by_the_programs_innermost_span():
    """The harness names each idle gap by the innermost host range at its
    middle: the program's ``field.*`` span or a torch op inside it, and
    ``portbench.field`` only outside the program's ranges."""
    host = [(200, 900, "field.key"), (950, 4_200, "invocation.field"),
            (1_000, 3_000, "field.depth"), (1_100, 1_200, "aten::index")]
    ops = [(0, 300), (900, 1_000), (1_200, 2_900), (3_000, 4_300), (4_500, 10_000)]
    gaps = dict(_trace(host, ops).breakdown()["idle_gaps"])
    assert gaps == pytest.approx({"host: field.key": 600 / 1e9,
                                  "host: aten::index": 200 / 1e9,
                                  "host: field.depth": 100 / 1e9,
                                  "host: portbench.field (no torch op)": 200 / 1e9})


class _Registry:
    def __init__(self, snap):
        self.snap = snap

    def snapshot(self):
        return dict(self.snap)


@pytest.mark.parametrize("snap,want", [
    ({"field_evaluations_total": 4, "field_readback_bytes_total": 4 * 942e6,
      "vm_step_launches_total": 16, "graph_build_seconds_stage_edges_count": 1,
      "graph_build_seconds_stage_edges_sum": 9.5, "graph_build_seconds_stage_csr_count": 1,
      "graph_build_seconds_stage_csr_sum": 7.25},
     {"field.readback_mb": 942.0, "vm_step.launches": 4.0, "setup.edges_s": 9.5,
      "setup.csr_s": 7.25}),
    # the CPU: no launch, no build observed
    ({"field_evaluations_total": 2, "field_readback_bytes_total": 316e6},
     {"field.readback_mb": 158.0, "vm_step.launches": None, "setup.edges_s": None,
      "setup.csr_s": None}),
    ({}, dict.fromkeys(COUNTED)),
])
def test_counter_readers(monkeypatch, snap, want):
    import repro_torch.obs as obs

    monkeypatch.setattr(obs, "default_registry", lambda: _Registry(snap))
    assert {name: registry.reader(name)(_record()) for name in COUNTED} == want


def test_counter_readers_read_nothing_from_a_program_without_them(monkeypatch):
    """The parent's program has no ``default_registry``: no value, no raise."""
    import repro_torch.obs as obs

    monkeypatch.delattr(obs, "default_registry")
    assert [registry.reader(name)(_record()) for name in COUNTED] == [None] * 4


_RUN = """
import json, sys, time
sys.path[:0] = [{root!r}, {root!r} + "/src"]
from portbench import cell, registry
bench = registry.load_benchmark()
out = cell.run_cell(bench, "pg1m-pq-hash", 2**31 + 11, 0.3, True, "cpu", time.perf_counter(),
                    overrides={{"n": 2000}})
import repro_torch.obs as obs
snap = obs.default_registry().snapshot()
print(json.dumps({{"metrics": out["metrics"], "snap": snap}}))
"""


def test_a_traced_cpu_run_reports_the_programs_counters():
    """One traced CPU run in a process of its own: the bytes read back a call
    are the outputs' (alpha, three per-vertex vectors, the edge masses, the
    dense ``ext_to``), the graph build's two stages are reported, and what
    needs the card (launches, device idle) is left out."""
    proc = subprocess.run([sys.executable, "-c", _RUN.format(root=str(ROOT))], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    metrics, snap = got["metrics"], got["snap"]
    from repro_torch.core.rpq import parse_rpq
    from repro_torch.core.tpstry import TPSTry
    from repro_torch.graphs.graph import LabelledGraph

    cfg = registry.config(registry.load_benchmark(ROOT), "pg1m-pq")
    cfg["graph"]["n"] = n = 2000
    labels, edges = cell.make_data(cfg, 2**31 + 11, "cpu")
    g = LabelledGraph.from_undirected_edges(n, labels, edges, list(cfg["graph"]["labels"]))
    n_cols = TPSTry.from_workload([(parse_rpq(q), f) for q, f in cfg["workload"]],
                                  star_max=int(cfg["star_max"])).compile(g.label_names).n_nodes
    per_call = 4 * (n * n_cols + 3 * n + g.m + n * int(cfg["k"]))
    assert snap["field_readback_bytes_total"] == per_call * snap["field_evaluations_total"]
    assert metrics["field.readback_mb"] == {"value": per_call / 1e6, "unit": "MB"}
    assert metrics["setup.edges_s"]["value"] > 0 and metrics["setup.csr_s"]["value"] > 0
    assert snap["graph_build_seconds_stage_edges_count"] == 1
    assert snap["graph_build_seconds_stage_csr_count"] == 1
    assert "vm_step.launches" not in metrics and "field.host_ms" not in metrics
