"""Spans and counters inside ``Taper.field`` (``repro_torch.obs``).

One span entry point (``obs.trace.span``) mirrors the program's spans into
``torch.profiler`` while it records and into a wired, sampled invocation
trace; with neither, no profiler range is entered.  The field's spans
are ``field.key``, then, unless the memo answers, ``invocation.field``
with ``field.inputs``, one ``field.depth`` a DP depth step,
``field.aggregates``, ``field.readback`` and ``field.store`` inside it.
The process registry (``obs.default_registry()``) counts evaluations,
bytes read back, ``vm_step`` launches (on the card) and the graph build's
seconds by stage.  The CPU tests run the ``torch`` backends on a small provgen graph;
the card's test is marked ``cuda`` and skips without one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_obs_field.py
"""
import numpy as np
import pytest
import torch

import repro_torch.obs.trace as trace_mod
from repro_torch.core.rpq import parse_rpq
from repro_torch.core.taper import Taper, TaperConfig
from repro_torch.core.tpstry import TPSTry
from repro_torch.graphs.generators import provgen_like
from repro_torch.graphs.graph import LabelledGraph
from repro_torch.graphs.partition import hash_partition
from repro_torch.obs import BUILD_BUCKETS, NOOP_SPAN, Tracer, default_registry, event, span

PQ = [("Entity.(Entity)*.Entity", 0.4), ("Agent.Activity.Entity.Entity.Activity.Agent", 0.2),
      ("(Entity)*.Activity.Entity", 0.2), ("Entity.Activity.(Agent)*", 0.2)]
K = 4
#: the field's spans under ``invocation.field``, in the order they open
CHILDREN = ("field.inputs", "field.depth", "field.aggregates", "field.readback",
            "field.store")
BACKENDS = ["torch", "torch_sharded"]


def _setup(backend="torch", device="cpu", n=1500, seed=5):
    g = provgen_like(n, seed=seed)
    trie = TPSTry.from_workload([(parse_rpq(q), f) for q, f in PQ]).compile(g.label_names)
    taper = Taper(g, K, TaperConfig(field_backend=backend), device=device)
    return taper, trie, hash_partition(g.n, K, seed=seed)


def _moved(part, i):
    """``part`` with the first ``10 * i`` vertices moved to the next part."""
    out = part.copy()
    out[:10 * i] = (out[:10 * i] + 1) % K
    return out


def _profiled(fn):
    """``fn()`` under a CPU ``torch.profiler``; its result and the program's
    ranges ``(name, start_ns, end_ns)``, by start."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = sorted(((e.name(), int(e.start_ns()), int(e.end_ns()))
                     for e in prof.profiler.kineto_results.events()
                     if e.name().startswith(("invocation.", "field."))), key=lambda r: r[1])
    return out, ranges


def _steps(trie):
    return int(trie.max_depth) - 1


def _counts():
    snap = default_registry().snapshot()
    return {k: snap.get(k, 0.0) for k in (
        "field_evaluations_total", "field_readback_bytes_total", "vm_step_launches_total",
        "graph_build_seconds_stage_edges_count", "graph_build_seconds_stage_csr_count")}


def _delta(before):
    after = _counts()
    return {k: after[k] - before[k] for k in before}


@pytest.mark.parametrize("backend", BACKENDS)
def test_profiler_sees_the_field_span_tree(backend):
    """One call under the profiler: ``field.key``, then ``invocation.field``
    holding every other ``field.*`` span, in order, one ``field.depth`` a
    depth step."""
    taper, trie, part = _setup(backend)
    taper.field(part, trie)                      # set-up outside the trace
    fld, ranges = _profiled(lambda: taper.field(_moved(part, 1), trie))
    assert [r[0] for r in ranges[:2]] == ["field.key", "invocation.field"]
    assert ranges[0][2] <= ranges[1][1]
    _, t0, t1 = ranges[1]
    kids = ranges[2:]
    assert all(t0 <= a <= b <= t1 for _, a, b in kids)
    names = [r[0] for r in kids]
    assert names == (["field.inputs"] + ["field.depth"] * _steps(trie)
                     + ["field.aggregates", "field.readback", "field.store"])
    # siblings do not overlap: each opens after the last one closed
    assert all(b[1] >= a[2] for a, b in zip(kids, kids[1:]))
    assert fld.alpha.shape == (taper.g.n, trie.n_nodes)


def test_program_ranges_are_host_only():
    """The program's ranges are function-scope records, not user annotations:
    Kineto draws a user annotation on the device's timeline too, as a range
    over the kernels it holds, which would read as device work."""
    taper, trie, part = _setup()
    taper.field(part, trie)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("harness.span"):
            taper.field(_moved(part, 7), trie)
    evs = {e.name(): e for e in prof.profiler.kineto_results.events()}
    assert evs["harness.span"].is_user_annotation()
    for name in ("field.key", "invocation.field") + CHILDREN:
        assert not evs[name].is_user_annotation(), name
        assert str(evs[name].device_type()).endswith("CPU"), name


def test_memo_hit_records_the_root_alone():
    """A memo hit records its ``field.key`` span alone: no evaluation's
    root, no evaluation counted and no byte read back."""
    taper, trie, part = _setup()
    taper.field(part, trie)
    before = _counts()
    _, ranges = _profiled(lambda: taper.field(part, trie))
    assert [r[0] for r in ranges] == ["field.key"]
    tr = Tracer()
    taper.tracer, taper.trace_ctx = tr, tr.new_trace()
    taper.field(part, trie)
    (key,) = tr.spans()
    assert key["name"] == "field.key" and key["parent_id"] == taper.trace_ctx.span_id
    d = _delta(before)
    assert d["field_evaluations_total"] == 0 and d["field_readback_bytes_total"] == 0


def test_no_profiler_range_without_profiler_or_tracer(monkeypatch):
    """With no profiler recording and no tracer wired, the gate is asked
    once a span and no profiler range is entered."""
    taper, trie, part = _setup()
    taper.field(part, trie)
    asked = []

    def gate():
        asked.append(1)
        return False

    def forbidden(name):
        raise AssertionError(f"a profiler range {name!r} opened with the profiler off")

    monkeypatch.setattr(trace_mod, "_profiler_enabled", gate)
    monkeypatch.setattr(trace_mod, "_RecordFunctionFast", forbidden)
    taper.field(_moved(part, 2), trie)
    # the key, the root, its children less one, a depth span a step
    assert len(asked) == 2 + len(CHILDREN) - 1 + _steps(trie)
    asked.clear()
    taper.field(_moved(part, 2), trie)                     # a memo hit
    assert len(asked) == 1
    # the swap's and the re-deal's mirrors pass the same gate
    taper.invoke(_moved(part, 3), trie, max_iterations=1)
    event("invocation.redeal")


def test_span_off_is_the_noop_singleton():
    assert span("x") is NOOP_SPAN
    assert NOOP_SPAN.child("y") is NOOP_SPAN
    tr = Tracer(enabled=False)
    assert span("x", tr, tr.new_trace()) is NOOP_SPAN


def test_event_and_nested_spans_mirror_to_the_profiler():
    tr = Tracer()
    ctx = tr.new_trace()

    def body():
        with span("invocation.field", tr, ctx, backend="torch") as sp:
            with sp.child("field.depth", depth=1) as d:
                d.set(halo_bytes=8)
            event("invocation.redeal", tr, sp.context(), redeal_epoch=1)

    _, ranges = _profiled(body)
    assert [r[0] for r in ranges] == ["invocation.field", "field.depth", "invocation.redeal"]
    by = {s["name"]: s for s in tr.spans()}
    assert by["field.depth"]["attrs"] == {"depth": 1, "halo_bytes": 8}
    assert by["field.depth"]["parent_id"] == by["invocation.field"]["span_id"]
    assert by["invocation.redeal"]["duration_s"] == 0.0
    assert by["invocation.field"]["attrs"] == {"backend": "torch"}


@pytest.mark.parametrize("backend", BACKENDS)
def test_wired_tracer_gets_the_same_tree_on_the_profilers_clock(backend):
    """A wired sampled trace records the profiler's tree, ``field.key``
    beside ``invocation.field`` and the rest under it; each span's exported
    ``wall`` interval lies within 1 ms of the profiler's range of the same
    span."""
    taper, trie, part = _setup(backend)
    taper.field(part, trie)
    tr = Tracer()
    taper.tracer, taper.trace_ctx = tr, tr.new_trace()
    fld, ranges = _profiled(lambda: taper.field(_moved(part, 4), trie))
    spans = tr.spans()
    assert [s["name"] for s in spans] == [r[0] for r in ranges]
    key, root = spans[:2]
    assert key["name"] == "field.key" and root["name"] == "invocation.field"
    assert key["parent_id"] == root["parent_id"] == taper.trace_ctx.span_id
    assert all(s["parent_id"] == root["span_id"] for s in spans[2:])
    depths = [s for s in spans if s["name"] == "field.depth"]
    assert [s["attrs"]["depth"] for s in depths] == list(range(1, _steps(trie) + 1))
    if backend == "torch_sharded":
        halo = taper._pre["_halo_stats"]["halo_bytes_per_depth"]
        assert all(s["attrs"]["halo_bytes"] == halo for s in depths)
        assert all(s["duration_s"] > 0 for s in depths)
    rb = next(s for s in spans if s["name"] == "field.readback")
    assert rb["attrs"]["bytes"] == sum(a.nbytes for a in (
        fld.alpha, fld.pr, fld.edge_mass, fld.extro_mass, fld.extroversion, fld.ext_to))
    for s, (name, a, b) in zip(spans, ranges):
        assert abs(s["wall"] * 1e9 - a) < 1e6, name
        assert abs((s["wall"] + s["duration_s"]) * 1e9 - b) < 1e6, name


@pytest.mark.parametrize("dense_ext_to", [True, False])
def test_readback_bytes_are_the_returned_arrays(dense_ext_to):
    taper, trie, part = _setup()
    taper.config.dense_ext_to = dense_ext_to
    taper.field(part, trie)
    before = _counts()
    fields = [taper.field(_moved(part, i), trie) for i in (5, 6)]
    taper.field(_moved(part, 6), trie)                     # a memo hit
    nbytes = sum(a.nbytes for f in fields for a in (
        f.alpha, f.pr, f.edge_mass, f.extro_mass, f.extroversion, f.ext_to) if a is not None)
    n, m, N = taper.g.n, taper.g.m, trie.n_nodes
    assert nbytes == 2 * 4 * (n * N + 3 * n + m + (n * K if dense_ext_to else 0))
    d = _delta(before)
    assert d["field_readback_bytes_total"] == nbytes
    assert d["field_evaluations_total"] == 2
    assert d["vm_step_launches_total"] == 0                 # the CPU makes no launch


def test_graph_build_seconds_by_stage():
    """One ``edges`` build, one ``csr`` build and no second on a repeated
    ``vm_csr()`` nor in the fields' uploads."""
    src = provgen_like(800, seed=9)
    edges = np.stack([src.src, src.dst], axis=1)
    edges = edges[edges[:, 0] < edges[:, 1]]
    before = _counts()
    g = LabelledGraph.from_undirected_edges(src.n, src.labels, edges, src.label_names)
    assert _delta(before)["graph_build_seconds_stage_edges_count"] == 1
    assert g.vm_csr() is g.vm_csr()
    d = _delta(before)
    assert d["graph_build_seconds_stage_csr_count"] == 1
    hist = default_registry().histogram("graph_build_seconds", buckets=BUILD_BUCKETS,
                                        stage="csr")
    assert hist.sum > 0
    trie = TPSTry.from_workload([(parse_rpq(q), f) for q, f in PQ]).compile(g.label_names)
    taper = Taper(g, K, TaperConfig(), device="cpu")
    part = hash_partition(g.n, K, seed=1)
    taper.field(part, trie)
    taper.field(_moved(part, 1), trie)
    d = _delta(before)
    assert d["graph_build_seconds_stage_edges_count"] == 1
    assert d["graph_build_seconds_stage_csr_count"] == 1


@pytest.mark.cuda
def test_vm_step_launches_a_depth_step_on_the_card():
    """On the card, one launch of the kernel a DP depth step of a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc) to build and run the vm_step kernel")
    taper, trie, part = _setup("cuda", "cuda")
    taper.field(part, trie)
    before = _counts()
    for i in (1, 2, 3):
        taper.field(_moved(part, i), trie)
    d = _delta(before)
    assert d["field_evaluations_total"] == 3
    assert d["vm_step_launches_total"] == 3 * _steps(trie)
