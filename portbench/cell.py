"""One run of one cell: set-up, the measured window, the comparison with the
reference, the metrics.

Set-up makes the graph from the seed, builds the program's graph, CSR,
``Taper`` and compiled trie, and runs one warm evaluation.  The window is a
closed loop of one caller: draw the next partitioning (``loadgen.Draws``),
call ``Taper.field`` on it, until ``seconds`` have passed.  A reservoir sample
of the calls, drawn from the seed, keeps each sampled call's partitioning and
returned field; after the window, with the program's state freed, the plain
reference recomputes each sampled field in float64 and ``compare`` judges
it.  With ``traced``, ``torch.profiler`` records the window and the harness's
spans around its calls into the program.
"""
from __future__ import annotations

import contextlib
import gc
import sys
import time
import traceback
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import compare, loadgen, registry
from portbench import devtrace as tr
from portbench.counts.vm_step import launch_cost
from portbench.data.schema_graph import schema_graph
from portbench.reference import field as ref_field
from portbench.reference import trie as ref_trie


@dataclass
class RunRecord:
    """What the metric readers read."""

    setup_s: float
    graph_s: float
    eval_s: List[float]            # host seconds of each completed call
    window_s: float
    peak_bytes: int
    peaks: Optional[Dict]      # the card's row of peaks.json
    trace: Optional[tr.Trace] = None
    vm_step: Optional[Dict] = None  # traced runs: bytes and FLOP of the launches


def sub_seeds(seed: int) -> Dict[str, int]:
    """Independent streams of one ``--seed``: the graph, the moves, the
    sample of compared calls, the warm-up draw."""
    state = np.random.SeedSequence(int(seed) % 2**64).generate_state(4, dtype=np.uint64)
    return dict(zip(("graph", "moves", "sample", "warm"), (int(s) for s in state)))


def make_data(cfg: Dict, seed: int, device) -> Tuple[np.ndarray, np.ndarray]:
    """The graph maker's ``labels`` (n,) int32 and ``edges`` (e, 2) int64 on
    the host; its device buffers are freed."""
    labels, edges = schema_graph(cfg["graph"], sub_seeds(seed)["graph"], device)
    out = labels.cpu().numpy(), edges.cpu().numpy()
    del labels, edges
    return out


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@dataclass
class Program:
    """The system under test, built in set-up."""

    graph: object
    taper: object
    trie: object            # the compiled TrieArrays
    graph_s: float


def build_program(cfg: Dict, labels: np.ndarray, edges: np.ndarray, start: np.ndarray,
                  device) -> Program:
    """The port's graph and CSR, its ``Taper`` and compiled trie, and one warm
    evaluation at ``start``; ``graph_s`` is the host time of it all."""
    from repro_torch.core.rpq import parse_rpq
    from repro_torch.core.taper import Taper, TaperConfig
    from repro_torch.core.tpstry import TPSTry
    from repro_torch.graphs.graph import LabelledGraph

    spec = cfg["graph"]
    workload = [(parse_rpq(q), float(f)) for q, f in cfg["workload"]]
    t0 = time.perf_counter()
    g = LabelledGraph.from_undirected_edges(int(spec["n"]), labels, edges, list(spec["labels"]))
    g.vm_csr()
    taper = Taper(g, int(cfg["k"]), TaperConfig(dense_ext_to=bool(cfg["dense_ext_to"])),
                  device=device)
    trie = TPSTry.from_workload(workload, star_max=int(cfg["star_max"])).compile(g.label_names)
    taper.field(start, trie)
    _sync(device)
    return Program(g, taper, trie, time.perf_counter() - t0)


def warm_up(prog: Program, draws: loadgen.Draws, seconds: float) -> None:
    """Calls as the window makes them, on draws of their own, for
    ``seconds`` (at least one): the first seconds after the program's set-up
    run slower than the rest, as the host settles."""
    t_end = time.perf_counter() + seconds
    while True:
        prog.taper.field(draws.next().cpu().numpy(), prog.trie)
        if time.perf_counter() >= t_end:
            break


@dataclass
class Window:
    eval_s: List[float]
    window_s: float
    attempted: int
    failed: int
    kept: List[Tuple[np.ndarray, object]]   # (partitioning, field) of sampled calls
    trace: Optional[tr.Trace]


def run_window(prog: Program, draws: loadgen.Draws, seconds: float, sample: int,
               sample_seed: int, traced: bool, device) -> Window:
    """Call ``Taper.field`` on fresh partitionings until ``seconds`` have
    passed (the call under way then completes)."""
    rng = np.random.default_rng(sample_seed)
    span = torch.profiler.record_function if traced else (lambda name: contextlib.nullcontext())
    kept: List[Tuple[np.ndarray, object]] = []
    eval_s: List[float] = []
    attempted = failed = 0
    prof = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    t0 = time.perf_counter()
    t_end = t0 + seconds
    with span(tr.WINDOW):
        while attempted == 0 or time.perf_counter() < t_end:
            with span(tr.DRAW):
                part = draws.next().cpu().numpy()
            attempted += 1
            t1 = time.perf_counter()
            try:
                with span(tr.FIELD):
                    result = prog.taper.field(part, prog.trie)
            except Exception:  # the loop keeps running; a failed call fails the run
                failed += 1
                traceback.print_exc(file=sys.stderr)
                continue
            eval_s.append(time.perf_counter() - t1)
            if len(kept) < sample:
                kept.append((part, result))
            else:
                j = int(rng.integers(0, len(eval_s)))
                if j < sample:
                    kept[j] = (part, result)
            del result
    window_s = time.perf_counter() - t0
    trace = None
    if prof is not None:
        prof.stop()
        trace = tr.from_profiler(prof)
        del prof
    return Window(eval_s, window_s, attempted, failed, kept, trace)


def check_calls(cfg: Dict, labels: np.ndarray, edges: np.ndarray, trie_prog, kept,
                device) -> Tuple[Dict[str, float], Dict]:
    """The merged compared numbers of the kept calls, and the reference's
    graph (reused for the traced run's counts)."""
    names = list(cfg["graph"]["labels"])
    rtrie = ref_trie.build(cfg["workload"], int(cfg["star_max"]))
    graph = ref_field.build_graph(int(cfg["graph"]["n"]), labels, edges, len(names), device)
    prog_paths = compare.column_paths(trie_prog.parent, trie_prog.label, names)
    label_ids = {s: i for i, s in enumerate(names)}
    readings = []
    for part, result in kept:
        ref = ref_field.field(graph, rtrie, label_ids, part, int(cfg["k"]),
                              bool(cfg["dense_ext_to"]), torch.float64)
        readings.append(compare.compare(result, ref, prog_paths, rtrie.paths,
                                        bool(cfg["dense_ext_to"])))
        del ref
    return compare.merge(readings), {"graph": graph, "trie": rtrie}


def vm_step_counts(cfg: Dict, ref: Dict, start: np.ndarray, mix: Dict, seed: int,
                   calls: int, device) -> Dict:
    """Bytes and FLOP of every ``vm_step`` launch of the traced calls: the
    calls' partitionings drawn again from the seed, one launch a depth step."""
    graph, rtrie = ref["graph"], ref["trie"]
    draws = loadgen.Draws(start, int(cfg["k"]), float(mix["move_frac"]),
                          sub_seeds(seed)["moves"], device)
    per_call = rtrie.max_depth - 1
    nbytes = flops = 0
    for _ in range(calls):
        b, f = launch_cost(graph["src"], graph["dst"], draws.next(), graph["n"],
                           len(rtrie.paths), len(cfg["graph"]["labels"]))
        nbytes += b * per_call
        flops += f * per_call
    return {"bytes": nbytes, "flops": flops}


def device_kind(device) -> str:
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def run_cell(bench: Dict, cell_name: str, seed: int, seconds: float, traced: bool,
             device, t_start: float, overrides: Optional[Dict] = None) -> Dict:
    """One run; returns the result line's object (``compared`` last)."""
    cell = registry.workload(bench, cell_name)
    cfg = registry.config(bench, cell["config"])
    if overrides:
        cfg["graph"].update(overrides)
    mix = registry.traffic(cell["traffic"])
    loadgen.check_mix(mix)
    checks = registry.checks(cell_name)
    seeds = sub_seeds(seed)
    cuda = torch.device(device).type == "cuda"

    labels, edges = make_data(cfg, seed, device)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    k = int(cfg["k"])
    start = loadgen.start_partition(mix, labels, k, seed)
    prog = build_program(cfg, labels, edges, start, device)
    warm_up(prog, loadgen.Draws(start, k, float(mix["move_frac"]), seeds["warm"], device),
            float(mix["warm_seconds"]))
    draws = loadgen.Draws(start, k, float(mix["move_frac"]), seeds["moves"], device)
    _sync(device)
    setup_s = time.perf_counter() - t_start

    win = run_window(prog, draws, seconds, int(checks["sample"]), seeds["sample"], traced,
                     device)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    trie_prog = prog.trie
    graph_s = prog.graph_s
    del prog, draws
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    numbers, ref = check_calls(cfg, labels, edges, trie_prog, win.kept, device)
    numbers["failed_calls"] = float(win.failed)
    kind = device_kind(device)
    record = RunRecord(setup_s=setup_s, graph_s=graph_s, eval_s=win.eval_s,
                       window_s=win.window_s, peak_bytes=int(peak),
                       peaks=registry.peaks(kind), trace=win.trace)
    if traced:
        record.vm_step = vm_step_counts(cfg, ref, start, mix, seed, len(win.eval_s), device)
    del ref
    judged = compare.judge(numbers, checks["limits"])
    correct = (win.failed == 0 and len(win.kept) >= 1
               and all(v["ok"] for v in judged.values()))

    metrics = {}
    for m in registry.metrics_of(bench, cell_name, traced):
        value = registry.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
           "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": win.attempted, "failed": win.failed,
           "metrics": metrics, "device": dev}
    if traced and win.trace is not None:
        dev["busy_s"] = win.trace.busy_ns(win.trace.ops) / 1e9
        dev["window_s"] = win.trace.window_ns() / 1e9
        out["breakdown"] = win.trace.breakdown()
    out["compared"] = {name: {"value": v["value"], "limit": v["limit"]}
                       for name, v in judged.items()}
    return out
