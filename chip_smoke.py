#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on the machine with the card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit; build the CUDA kernels from the sources
   in the checkout (``nvcc``, ``sm_90a``, one process per source);
2. each kernel against its plain PyTorch version on the card, over seeded
   shapes: ``vm_step`` (the transitions of workload tries: PQ, MQ, seeded
   label chains of one to four 32-column blocks and the row placement's
   677-node trie, 3 to 26 labels; empty rows, hub rows of 12k in-edges,
   all-cut weights, up to 100k rows), ``embedding_bag`` (d 8/64/128, H 1/8/64,
   repeated, padded and out-of-range ids) and ``segment_spmm`` (F 8/16/100,
   empty rows, a hub row of 10k edges, zero weights);
3. the paper's worked-example values through ``backend="cuda"``;
4. fig7 at N=2000 on the card (provgen and musicbrainz, hash start): the
   reference's final ipt exactly, and the kernel field bitwise equal to the
   plain field on the CPU;
5. path 1, TAPER at the paper's ProvGen scale: one ``Taper.invoke`` on
   ``provgen_like(1_000_000)``, k=8, PQ1-4, kernel field, with per-iteration
   field/kernel/swap times, a bitwise repeat of the field, and the kernel's
   time, bound and plain-version time at those shapes;
6. path 2, DLRM serving at full ``dlrm-rm2`` width with ``multi_hot=8``
   (33,762,577 x 64 table on the card): 20 ``serve_p99`` and 3
   ``serve_bulk`` requests through ``serve_step``, kernel forward against
   plain forward, per-request latency and per-launch kernel time, one
   ``retrieval_step`` over 10^6 candidates, the bag kernel against its
   plain version on independent zipf ids over the whole table;
7. path 3, TAPER's embedding-row placement (``benchmarks/dlrm_span.py``'s
   settings): ``coaccess_graph`` -> ``Taper.invoke`` (kernel field, 677-node
   trie) -> ``query_span``: the plain field's partitions and the JAX
   package's spans exactly, and the kernel's time, bound and plain time at
   the path's shapes;
8. path 4, GCN inference (``gcn-cora``) on the ``ogb_products`` cell
   (2,449,029 nodes, 61,859,140 edges): three forwards, kernel forward
   against plain forward, and each kernel's time, bound, plain time and
   library time at the path's shapes.

Each path runs with every kernel's launch count set to 0 just before it and
read just after; a path that launched none of its kernels fails.  The line
before the last is the ``kernels`` JSON record; the last line is
``{"ok": true, "device": {...}}``.  The script imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: fig7 at N=2000 (benchmarks/fig7_convergence.py, BENCH_PR5..PR10.json)
FIG7_FINAL = {"provgen": 908300, "musicbrainz": 96536}
PQ = ["Entity.(Entity)*.Entity", "Agent.Activity.Entity.Entity.Activity.Agent",
      "(Entity)*.Activity.Entity", "Entity.Activity.(Agent)*"]
PQ_FREQ = (0.4, 0.2, 0.2, 0.2)
MQ = ["Area.Artist.(Artist|Label).Area",
      "Artist.Credit.(Track|Recording).Credit.Artist",
      "Artist.Credit.Track.Medium"]
MQ_FREQ = (0.2, 0.3, 0.5)
#: full-size cell: the paper's ProvGen scale (~1M vertices, paper §6.1)
FULL_N = 1_000_000
FULL_MAX_ITERS = 8
#: kernel vs plain tolerance (float32; the sums run in different orders)
RTOL, ATOL = 1e-5, 1e-6
#: H100 SXM data-sheet peaks (dense): HBM3 bytes/s, float32 (non-tensor) FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
#: embedding_bag and segment_spmm against their plain versions (the
#: tolerances of tests/test_torch_embedding_bag.py and
#: tests/test_torch_segment_spmm.py); model forwards kernel vs plain
BAG_RTOL, BAG_ATOL = 1e-4, 1e-5
SPMM_RTOL, SPMM_ATOL = 1e-4, 1e-4
DLRM_RTOL, DLRM_ATOL = 1e-5, 1e-6
GCN_RTOL, GCN_ATOL = 1e-4, 1e-5
#: DLRM serving: ids per field, requests per shape cell
DLRM_MULTI_HOT = 8
DLRM_REQUESTS = {"serve_p99": 20, "serve_bulk": 3}
#: row placement (benchmarks/dlrm_span.py): shards, and the spans the JAX
#: package's flow gives (hash, TAPER); tests/test_torch_dlrm.py holds the
#: port's CPU flow equal to that flow
SPAN_K = 64
SPAN_REFERENCE = (21.61865234375, 16.607177734375)
GCN_FORWARDS = 3
#: the kernels' wrappers, by the name of their launch counter
KERNELS = {
    "vm_step": ("repro_torch.kernels.vm_step.ops", "vm_step"),
    "embedding_bag": ("repro_torch.kernels.embedding_bag.ops", "embedding_bag"),
    "segment_spmm": ("repro_torch.kernels.segment_spmm.ops", "segment_spmm_csr"),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*args):
    print(*args, flush=True)


def _wrapper(name):
    import importlib

    module, attr = KERNELS[name]
    return getattr(importlib.import_module(module), attr)


def reset_counts():
    """Every kernel's launch count to 0: a path starts here."""
    for name in KERNELS:
        _wrapper(name).launches = 0


def read_counts(path, needs):
    """The launch counts just after a path; fails if it launched none of
    the kernels in ``needs``."""
    counts = {name: _wrapper(name).launches for name in KERNELS}
    log(f"[{path}] kernel launches on the path: {counts}")
    for name in needs:
        check(counts[name] > 0, f"{path}: the path launched no {name} kernel")
    return counts


def _bound(bytes_moved, flops):
    """(bound in ms, "bytes" or "operations") on the data-sheet peaks."""
    t_b, t_f = bytes_moved / PEAK_BYTES_S, flops / PEAK_F32_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


# ---------------------------------------------------------------------------
# phase 1: device and build
# ---------------------------------------------------------------------------


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def build_kernels():
    from repro_torch.kernels.build import build_all

    t0 = time.perf_counter()
    libs = build_all()
    dt = time.perf_counter() - t0
    log(f"[build] {len(libs)} kernel source(s) ready in {dt:.2f} s")
    for name, lib in libs.items():
        report = lib.with_name(lib.name + ".log")
        text = report.read_text() if report.exists() else "(cached build)"
        for line in text.splitlines():
            if "ptxas info" in line and ("registers" in line or "Compiling" in line):
                log(f"[build] {name}: {line.strip()}")
    return dt


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain
# ---------------------------------------------------------------------------


def _trie_columns(workload, label_names):
    """T's column form ``(par, val)`` of a compiled workload trie."""
    from repro_torch.core.tpstry import TPSTry
    from repro_torch.kernels.vm_step.ref import transition_columns

    arrays = TPSTry.from_workload(workload).compile(label_names)
    return transition_columns(arrays.parent, arrays.label, arrays.cond_p,
                              arrays.n_labels)


def _chain_trie(seed, L, n_queries, length):
    """Column form of the trie of ``n_queries`` seeded label chains of
    ``length`` labels over ``L`` labels."""
    import numpy as np
    from repro_torch.core.rpq import concat, label

    rng = np.random.default_rng(seed)
    w = [(concat(*(label(f"L{i}") for i in rng.integers(0, L, length))),
          1.0 / n_queries) for _ in range(n_queries)]
    return _trie_columns(w, [f"L{i}" for i in range(L)])


def _csr_case(torch, rng, n, e, par, val, hub=0, cut_frac=0.5, empty_frac=0.1,
              device="cuda"):
    """Seeded dst-sorted CSR inputs over a trie's column form ``(par,
    val)``: rows in ``empty_frac`` get no edges, ``hub`` edges all point at
    row 1, ``cut_frac`` of the weights are 0."""
    import numpy as np

    L, N = par.shape
    live = np.nonzero(rng.random(n) >= empty_frac)[0]
    dst = rng.choice(live, e)
    if hub:
        dst[:hub] = 1
    src = rng.integers(0, n, e)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n), out=row_ptr[1:])
    w = (rng.random(e) + 0.1).astype(np.float32)
    w[rng.random(e) < cut_frac] = 0.0
    t = lambda a, dt: torch.as_tensor(a, device=device).to(dt)  # noqa: E731
    return dict(
        alpha=t(rng.random((n, N)).astype(np.float32), torch.float32),
        par=t(par, torch.int32), val=t(val, torch.float32),
        row_ptr=t(row_ptr, torch.int32), src=t(src, torch.int32),
        w=t(w, torch.float32), row_label=t(rng.integers(0, L, n), torch.int32),
        dst=t(dst, torch.int64))


def _vm_args(c):
    return tuple(c[k] for k in ("alpha", "par", "val", "row_ptr", "src", "w",
                                "row_label"))


def _vm_plain(args):
    """The plain version of ``vm_step`` on the wrapper's arguments."""
    import torch
    from repro_torch.kernels.vm_step.ref import vm_step_reference

    alpha, par, val, row_ptr, src, w, row_label = args
    n = alpha.shape[0]
    dst = torch.repeat_interleave(torch.arange(n, device=alpha.device),
                                  (row_ptr[1:] - row_ptr[:-1]).long())
    return vm_step_reference(alpha, par, val, src, dst, w, row_label[dst], n)


def _vm_bound(args):
    """(bound ms, by, bytes, FLOP, local edges) of one ``vm_step`` launch:
    every input read once and the output written once; per local edge and
    trie column one gather-multiply, one scale and one add."""
    alpha, par, val, row_ptr, src, w, row_label = args
    n, N = alpha.shape
    L, E = par.shape[0], src.shape[0]
    nz = int((w != 0).sum())
    bytes_moved = 4 * ((n + 1) + 2 * E + n + 2 * n * N + 2 * L * N)
    flops = 3 * nz * N
    return (*_bound(bytes_moved, flops), bytes_moved, flops, nz)


def kernel_sweep(torch) -> float:
    import numpy as np
    from repro_torch.graphs.generators import musicbrainz_like
    from repro_torch.kernels.vm_step.ops import vm_step

    pq = _trie_columns(_workload(PQ, PQ_FREQ), ["Entity", "Activity", "Agent"])
    mq = _trie_columns(_workload(MQ, MQ_FREQ),
                       musicbrainz_like(50, seed=13).label_names)
    cases = [
        # (name, n, e, (par, val), hub, cut_frac)
        ("provgen-PQ", 3000, 20000, pq, 0, 0.5),
        ("musicbrainz-MQ", 3000, 20000, mq, 0, 0.5),
        ("chains-L3", 3000, 20000, _chain_trie(1, 3, 8, 4), 0, 0.5),
        ("chains-L12-two-blocks", 3000, 20000, _chain_trie(2, 12, 16, 3), 0, 0.5),
        ("chains-L12-many-blocks", 3000, 20000, _chain_trie(3, 12, 40, 4), 0, 0.5),
        ("hub-12k", 20000, 60000, pq, 12000, 0.3),
        ("all-cut", 5000, 30000, pq, 0, 1.0),
        ("n100k-provgen-like", 100_000, 553_000, pq, 0, 0.5),
        ("n100k-musicbrainz-like", 100_000, 553_000, mq, 0, 0.5),
        ("placement-trie-hub-12k", 20000, 200_000, _span_columns(), 12000, 0.5),
    ]
    worst = 0.0
    for i, (name, n, e, (par, val), hub, cut) in enumerate(cases):
        c = _csr_case(torch, np.random.default_rng(100 + i), n, e, par, val,
                      hub=hub, cut_frac=cut)
        args = _vm_args(c)
        out = vm_step(*args)
        torch.cuda.synchronize()
        ref = _vm_plain(args)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        ok = bool(torch.allclose(out, ref, rtol=RTOL, atol=ATOL))
        empty_rows = c["row_ptr"][1:] == c["row_ptr"][:-1]
        L, N = par.shape
        log(f"[kernel] vm_step {name}: n={n} E={e} N={N} L={L} "
            f"empty_rows={int(empty_rows.sum())} max_abs_err={err:.3e} "
            f"bitwise={bool(torch.equal(out, ref))} "
            f"allclose(rtol={RTOL}, atol={ATOL})={ok}")
        check(ok, f"vm_step kernel disagrees with its plain version on {name}")
        check(bool((out[empty_rows] == 0).all()),
              f"vm_step kernel wrote nonzero rows without edges on {name}")
        check(bool(torch.isfinite(out).all()), f"non-finite kernel output on {name}")
        worst = max(worst, err)
        if name == "n100k-provgen-like":
            # rows of even length: the kernel's cost per local edge without
            # the row-length skew of the main path's graph
            ms = _time_ms(torch, lambda: vm_step(*args), 20)
            nz = int((c["w"] != 0).sum())
            log(f"[kernel] vm_step {name} timing: {ms:.4f} ms, "
                f"{ms * 1e6 / nz:.3f} ns per local edge ({nz} local edges, "
                f"longest row {int((c['row_ptr'][1:] - c['row_ptr'][:-1]).max())})")
        del c, args, out, ref
    return worst


def _span_workload():
    """The row placement's workload: every ordered pair of the 26 fields
    (benchmarks/dlrm_span.py)."""
    from repro_torch.core.rpq import concat, label

    w = [(concat(label(f"F{i}"), label(f"F{j}")), 1.0)
         for i in range(26) for j in range(26) if i != j]
    return [(q, 1.0 / len(w)) for q, _ in w]


def _span_columns():
    """Column form of the row placement's 677-node trie over 26 labels."""
    return _trie_columns(_span_workload(), [f"F{f}" for f in range(26)])


def bag_sweep(torch) -> float:
    """``embedding_bag`` against its plain version on seeded shapes."""
    import numpy as np
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_reference

    worst = 0.0
    V, B = 100_000, 4096
    for i, (d, H) in enumerate((d, H) for d in (8, 64, 128) for H in (1, 8, 64)):
        rng = np.random.default_rng(300 + i)
        table = torch.as_tensor(rng.normal(size=(V, d)).astype(np.float32),
                                device="cuda")
        ids = rng.integers(0, V, (B, H))
        ids[::3] = ids[::3, :1]                       # one row repeated H times
        ids[::5, -1] = -1                             # pad slots
        ids[::7, 0] = V + 11                          # past the table
        ids = torch.as_tensor(ids.astype(np.int32), device="cuda")
        for combiner in ("sum", "mean"):
            out = embedding_bag(table, ids, combiner)
            torch.cuda.synchronize()
            ref = embedding_bag_reference(table, ids, combiner)
            err = float((out - ref).abs().max())
            ok = bool(torch.allclose(out, ref, rtol=BAG_RTOL, atol=BAG_ATOL))
            log(f"[kernel] embedding_bag d={d} H={H} {combiner}: V={V} B={B} "
                f"max_abs_err={err:.3e} bitwise={bool(torch.equal(out, ref))} "
                f"allclose(rtol={BAG_RTOL}, atol={BAG_ATOL})={ok}")
            check(ok, f"embedding_bag kernel disagrees with its plain version "
                      f"at d={d} H={H} {combiner}")
            worst = max(worst, err)
    return worst


def spmm_sweep(torch) -> float:
    """``segment_spmm`` against its plain version on seeded shapes."""
    import numpy as np
    from repro_torch.kernels.segment_spmm.ops import csr_from_edges, segment_spmm_csr
    from repro_torch.kernels.segment_spmm.ref import segment_spmm_reference

    worst = 0.0
    n, e = 50_000, 500_000
    for i, F in enumerate((8, 16, 100)):
        rng = np.random.default_rng(400 + i)
        live = np.nonzero(rng.random(n) >= 0.1)[0]   # 10% of the rows get no edge
        dst = rng.choice(live, e)
        dst[:10_000] = live[1]                        # a hub row of 10k edges
        src = rng.integers(0, n, e)
        w = rng.normal(size=e).astype(np.float32)
        w[rng.random(e) < 0.2] = 0.0                  # masked edges
        t = lambda a, dt: torch.as_tensor(a, device="cuda").to(dt)  # noqa: E731
        x = t(rng.normal(size=(n, F)).astype(np.float32), torch.float32)
        csr = csr_from_edges(t(src, torch.int32), t(dst, torch.int32), n)
        wc = t(w, torch.float32)[csr.order].contiguous()
        out = segment_spmm_csr(x, csr, wc)
        torch.cuda.synchronize()
        ref = segment_spmm_reference(x, t(src, torch.int64), t(dst, torch.int64),
                                     t(w, torch.float32), n)
        err = float((out - ref).abs().max())
        ok = bool(torch.allclose(out, ref, rtol=SPMM_RTOL, atol=SPMM_ATOL))
        empty = csr.row_ptr[1:] == csr.row_ptr[:-1]
        log(f"[kernel] segment_spmm F={F}: n={n} E={e} empty_rows={int(empty.sum())} "
            f"hub=10000 max_abs_err={err:.3e} allclose(rtol={SPMM_RTOL}, "
            f"atol={SPMM_ATOL})={ok}")
        check(ok, f"segment_spmm kernel disagrees with its plain version at F={F}")
        check(bool((out[empty] == 0).all()), "segment_spmm wrote nonzero empty rows")
        worst = max(worst, err)
    return worst


# ---------------------------------------------------------------------------
# phase 3: paper values
# ---------------------------------------------------------------------------


def paper_values(device):
    from repro_torch.core.rpq import parse_rpq
    from repro_torch.core.tpstry import TPSTry
    from repro_torch.core.visitor import extroversion_field, vm_cell
    from repro_torch.graphs.generators import (paper_example_graph,
                                               paper_example_partition)

    g = paper_example_graph()
    w = [(parse_rpq("a.(b|c).(c|d)"), 0.5), (parse_rpq("(c|a).c.a"), 0.5)]
    arrays = TPSTry.from_workload(w).compile(g.label_names)
    f = extroversion_field(g, arrays, paper_example_partition(), k=2,
                           backend="cuda", device=device)
    v3 = 2
    got = dict(pr=float(f.pr[v3]), extro_mass=float(f.extro_mass[v3]),
               extroversion=float(f.extroversion[v3]),
               introversion=float(f.introversion[v3]))
    want = dict(pr=0.5, extro_mass=0.0625, extroversion=0.125, introversion=0.875)
    log(f"[paper] v3 {got}")
    for k, v in want.items():
        check(abs(got[k] - v) <= 1e-7, f"paper value {k}(v3)={got[k]}, want {v}")
    row = vm_cell(g, arrays, [0, 1])
    check(max(abs(a - b) for a, b in zip(row, [0, 0, .25, .5, .25, 0])) <= 1e-7,
          f"VM row {row}")


# ---------------------------------------------------------------------------
# phase 4: fig7 at N=2000
# ---------------------------------------------------------------------------


def _workload(queries, freqs):
    from repro_torch.core.rpq import parse_rpq

    return [(parse_rpq(q), f) for q, f in zip(queries, freqs)]


def fig7(torch, device):
    import numpy as np
    from repro_torch.core.taper import Taper, TaperConfig
    from repro_torch.core.tpstry import TPSTry
    from repro_torch.core.visitor import extroversion_field
    from repro_torch.graphs.generators import musicbrainz_like, provgen_like
    from repro_torch.graphs.partition import hash_partition
    from repro_torch.workload.executor import QueryExecutor

    for name, gen, seed, w in (
            ("provgen", provgen_like, 11, _workload(PQ, PQ_FREQ)),
            ("musicbrainz", musicbrainz_like, 13, _workload(MQ, MQ_FREQ))):
        g = gen(2000, avg_degree=6.0, seed=seed)
        start = hash_partition(g.n, 8, seed=1)
        rep = Taper(g, 8, TaperConfig(max_iterations=8, seed=0),
                    device=device).invoke(start, w)
        ex = QueryExecutor(g)
        series = [round(ex.workload_ipt(w, p)) for p in rep.parts]
        final, want = series[-1], FIG7_FINAL[name]
        log(f"[fig7] {name} N=2000 iterations={rep.iterations} ipt={series} "
            f"final={final} reference={want} rel_diff={abs(final - want) / want:.5f}")
        check(final == want, f"fig7 {name}: final ipt {final}, reference {want}")
        # the kernel field against the plain field on the CPU, same state
        arrays = TPSTry.from_workload(w).compile(g.label_names)
        fc = extroversion_field(g, arrays, start, 8, backend="cuda", device=device)
        fp = extroversion_field(g, arrays, start, 8, backend="torch", device="cpu")
        same = all(np.array_equal(getattr(fc, k), getattr(fp, k))
                   for k in ("alpha", "pr", "edge_mass", "extro_mass",
                             "extroversion", "ext_to"))
        log(f"[fig7] {name} cuda field (card) == torch field (CPU) bitwise: {same}")
        check(same, f"fig7 {name}: the cuda field differs from the CPU field")


# ---------------------------------------------------------------------------
# phase 5: the main path at full size
# ---------------------------------------------------------------------------


class _KernelTimer:
    """Records CUDA events around every call of a kernel's wrapper that a
    path makes (no synchronisation), and the last arguments of each
    distinct argument shape; the wrapper's own launch count is untouched."""

    def __init__(self, torch, fn):
        self.torch, self.fn, self.events, self.last_args = torch, fn, [], None
        self.shapes, self.args_by_shape = [], {}

    def __call__(self, *args):
        ev0 = self.torch.cuda.Event(enable_timing=True)
        ev1 = self.torch.cuda.Event(enable_timing=True)
        ev0.record()
        out = self.fn(*args)
        ev1.record()
        self.events.append((ev0, ev1))
        self.last_args = args
        key = tuple(tuple(a.shape) for a in args if hasattr(a, "shape"))
        self.shapes.append(key)
        self.args_by_shape[key] = args
        return out

    def ms_by_shape(self):
        """{argument shapes: [ms of each launch]} (synchronise first)."""
        out = {}
        for key, (a, b) in zip(self.shapes, self.events):
            out.setdefault(key, []).append(a.elapsed_time(b))
        return out


def _time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    for _ in range(reps):
        fn()
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1) / reps


def full_size(torch, device):
    import numpy as np
    import repro_torch.core.visitor as visitor
    from repro_torch.core.taper import Taper, TaperConfig
    from repro_torch.core.tpstry import TPSTry
    from repro_torch.core.visitor import extroversion_field
    from repro_torch.graphs.generators import provgen_like
    from repro_torch.graphs.metrics import partition_balance
    from repro_torch.graphs.partition import hash_partition
    from repro_torch.kernels.vm_step.ops import vm_step
    from repro_torch.workload.executor import QueryExecutor

    t0 = time.perf_counter()
    g = provgen_like(FULL_N, avg_degree=6.0, seed=11)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    part0 = hash_partition(g.n, 8, seed=1)
    g.vm_csr()
    t_pack = time.perf_counter() - t0
    w = _workload(PQ, PQ_FREQ)
    log(f"[full] provgen_like n={g.n} m={g.m} k=8 hash start; generate "
        f"{t_gen:.2f} s, hash partition + vm packing {t_pack:.2f} s; "
        f"cuts: metis_like start skipped (host-bound), max_iterations="
        f"{FULL_MAX_ITERS}")

    timer = _KernelTimer(torch, vm_step)
    visitor.vm_step = timer
    try:
        taper = Taper(g, 8, TaperConfig(max_iterations=FULL_MAX_ITERS, seed=0),
                      device=device)
        reset_counts()                              # the path starts here
        t0 = time.perf_counter()
        rep = taper.invoke(part0, w)
        t_inv = time.perf_counter() - t0
        launches = read_counts("full", ["vm_step"])["vm_step"]  # ... ends here
    finally:
        visitor.vm_step = vm_step
    torch.cuda.synchronize()
    evals = len(rep.field_seconds)
    per_eval = launches // max(evals, 1)
    check(per_eval * evals == launches == len(timer.events),
          f"{launches} launches over {evals} field evaluations")
    kern_ms = [sum(a.elapsed_time(b) for a, b in timer.events[i * per_eval:(i + 1) * per_eval])
               for i in range(evals)]

    t0 = time.perf_counter()
    ex = QueryExecutor(g)
    ipt = [ex.workload_ipt(w, p) for p in rep.parts]
    t_ipt = time.perf_counter() - t0
    for i in range(evals):
        swap = (f"swap {rep.swap_seconds[i - 1]:.3f} s, moves {rep.moves[i - 1]}, "
                if i else "")
        log(f"[full] iteration {i}: {swap}field {rep.field_seconds[i]:.4f} s "
            f"(kernel {kern_ms[i]:.3f} ms over {per_eval} launches), "
            f"ipt {ipt[i]:.0f}")
    if len(rep.swap_seconds) > rep.iterations:
        log(f"[full] final swap (no moves): {rep.swap_seconds[-1]:.3f} s")
    field_s, swap_s = sum(rep.field_seconds), sum(rep.swap_seconds)
    log(f"[full] invocation {t_inv:.2f} s: {rep.iterations} iterations, "
        f"{rep.total_moves} moves, field {field_s:.3f} s "
        f"(kernel {sum(kern_ms):.3f} ms), swap {swap_s:.3f} s; "
        f"ipt {ipt[0]:.0f} -> {ipt[-1]:.0f} ({ipt[-1] / ipt[0]:.4f}); "
        f"ipt scoring {t_ipt:.2f} s; balance "
        f"{partition_balance(rep.final_part, 8):.4f}; vm_step launches {launches}")
    check(ipt[-1] < ipt[0], "the invocation did not reduce ipt")
    check(partition_balance(rep.final_part, 8) <= 1.0 + 0.05 + 1e-9,
          "final partition breaks the 5% balance bound")

    # the field twice on the same partition: bitwise repeatable
    final = rep.final_part
    arrays = TPSTry.from_workload(w).compile(g.label_names)
    f1 = extroversion_field(g, arrays, final, 8, _precomputed=taper._pre,
                            device=device)
    f2 = extroversion_field(g, arrays, final, 8, _precomputed=taper._pre,
                            device=device)
    names = ("alpha", "pr", "edge_mass", "extro_mass", "extroversion", "ext_to")
    for k in names:
        a = getattr(f1, k)
        check(np.array_equal(a, getattr(f2, k)), f"field {k} not bitwise repeatable")
        check(bool(np.isfinite(a).all()), f"field {k} not finite")
    check(f1.alpha.shape == (g.n, arrays.n_nodes) and f1.edge_mass.shape == (g.m,)
          and f1.ext_to.shape == (g.n, 8), "field output shapes")
    # the plain torch field on the card, same partition
    fp = extroversion_field(g, arrays, final, 8, _precomputed=taper._pre,
                            backend="torch", device=device)
    same = all(np.array_equal(getattr(f1, k), getattr(fp, k)) for k in names)
    log(f"[full] field twice on the final partition: bitwise equal; "
        f"cuda field == plain torch field on the card bitwise: {same}")
    check(same, "full-size cuda field differs from the plain field")

    # the kernel at the main path's shapes: its last launch's arguments
    return dict(launches=launches, **_vm_at_path_shapes(torch, "full", timer.last_args))


def _vm_at_path_shapes(torch, path, args):
    """The kernel's time, its plain version's, its bound and its error on
    the arguments of a path's last launch."""
    from repro_torch.kernels.vm_step.ops import vm_step

    alpha, par, val, row_ptr, src, wt, row_label = args
    n, N = alpha.shape
    L, E = par.shape[0], src.shape[0]
    ms = _time_ms(torch, lambda: vm_step(*args), 20)
    plain_ms = _time_ms(torch, lambda: _vm_plain(args), 3)
    out_k, out_p = vm_step(*args), _vm_plain(args)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    check(bool(torch.allclose(out_k, out_p, rtol=RTOL, atol=ATOL)),
          f"{path}: vm_step kernel disagrees with its plain version")
    bound_ms, bound_by, bytes_moved, flops, nz = _vm_bound(args)
    deg = (row_ptr[1:] - row_ptr[:-1]).long()
    rows = torch.repeat_interleave(torch.arange(n, device=deg.device), deg)
    local_deg = torch.bincount(rows[wt != 0], minlength=n)
    log(f"[{path}] vm_step rows: longest row {int(deg.max())} edges "
        f"({int(local_deg.max())} local); mean {E / n:.2f} edges "
        f"({nz / n:.2f} local); {ms * 1e6 / max(nz, 1):.3f} ns per local edge")
    log(f"[{path}] vm_step at n={n} E={E} N={N} L={L} (local edges {nz}): kernel "
        f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms by "
        f"{bound_by} ({bytes_moved} B, {flops} FLOP), max_abs_err {err:.3e} "
        f"bitwise={bool(torch.equal(out_k, out_p))}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                err=err)


# ---------------------------------------------------------------------------
# phase 6: DLRM serving at full width
# ---------------------------------------------------------------------------


def _unique_rows(torch, ids, V):
    u = torch.unique(ids)
    return int(((u >= 0) & (u < V)).sum())


def dlrm_serving(torch, device):
    import dataclasses
    import math

    import numpy as np
    import repro_torch.models.dlrm as dlrm
    from repro_torch.configs.base import DLRM_SHAPES
    from repro_torch.configs.registry import get_config
    from repro_torch.data.recsys import ClickLogPipeline
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_reference
    from repro_torch.models.gnn.common import mlp_apply

    cfg = dataclasses.replace(get_config("dlrm-rm2"), multi_hot=DLRM_MULTI_HOT)
    shapes = {s.name: s for s in DLRM_SHAPES}
    V, d = cfg.total_rows(), cfg.embed_dim
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = dlrm.init(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    log(f"[dlrm] {cfg.name} multi_hot={cfg.multi_hot}: table {V} x {d} float32 "
        f"({V * d * 4 / 1e9:.2f} GB) + MLPs, {cfg.n_params()} parameters, "
        f"initialised on the card in {t_init:.2f} s")

    t0 = time.perf_counter()
    requests = {}
    for seed, (name, count) in enumerate(DLRM_REQUESTS.items(), start=1):
        pipe = ClickLogPipeline(cfg, shapes[name].dim("batch"), seed=seed)
        requests[name] = [next(pipe) for _ in range(count)]
    log(f"[dlrm] click-log requests {', '.join(f'{k} {len(v)} x B={shapes[k].dim('batch')}' for k, v in requests.items())} "
        f"generated on the host in {time.perf_counter() - t0:.2f} s")

    def upload(req):
        return {k: torch.as_tensor(v, device=device) for k, v in req.items()
                if k != "labels"}

    timer = _KernelTimer(torch, embedding_bag)
    dlrm.embedding_bag = timer
    latency, split, last = {}, {}, {}
    try:
        reset_counts()                              # the path starts here
        for name, reqs in requests.items():
            latency[name], split[name] = [], []
            for req in reqs:
                t0 = time.perf_counter()
                batch = upload(req)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                prob = dlrm.serve_step(params, batch, cfg)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                prob = prob.cpu()
                t3 = time.perf_counter()
                latency[name].append(t3 - t0)
                split[name].append((t1 - t0, t2 - t1, t3 - t2))
            last[name] = (batch, prob)
        counts = read_counts("dlrm", ["embedding_bag"])  # ... and ends here
    finally:
        dlrm.embedding_bag = embedding_bag
    torch.cuda.synchronize()
    check(counts["embedding_bag"] == sum(len(r) for r in requests.values()),
          "one embedding_bag launch per request")
    per_launch = timer.ms_by_shape()
    for name, lat in latency.items():
        B = shapes[name].dim("batch")
        ids_shape = (B * cfg.n_sparse, cfg.multi_hot)
        ms = [v for k, v in per_launch.items() if k[1] == ids_shape][0]
        med = sorted(range(len(lat)), key=lat.__getitem__)[len(lat) // 2]
        log(f"[dlrm] {name} B={B}: request latency (upload, serve_step, read "
            f"back) ms {[round(x * 1e3, 3) for x in lat]}; median "
            f"{lat[med] * 1e3:.3f} ms = upload {split[name][med][0] * 1e3:.3f} + "
            f"serve_step {split[name][med][1] * 1e3:.3f} + read back "
            f"{split[name][med][2] * 1e3:.3f}; embedding_bag per launch ms "
            f"{[round(x, 4) for x in ms]}")

    # kernel forward against plain forward on the same batch
    def plain_bag(table, ids):
        return embedding_bag_reference(table, ids)

    worst = 0.0
    for name, (batch, prob) in last.items():
        check(prob.shape == (shapes[name].dim("batch"),), f"{name}: output shape")
        check(bool(torch.isfinite(prob).all() and ((prob >= 0) & (prob <= 1)).all()),
              f"{name}: probabilities outside [0, 1]")
        dlrm.embedding_bag = plain_bag
        try:
            plain = dlrm.serve_step(params, batch, cfg).cpu()
        finally:
            dlrm.embedding_bag = embedding_bag
        err = float((prob - plain).abs().max())
        ok = bool(torch.allclose(prob, plain, rtol=DLRM_RTOL, atol=DLRM_ATOL))
        log(f"[dlrm] {name}: kernel forward vs plain forward max_abs_err={err:.3e} "
            f"bitwise={bool(torch.equal(prob, plain))} allclose(rtol={DLRM_RTOL}, "
            f"atol={DLRM_ATOL})={ok}; mean click probability {float(prob.mean()):.4f}")
        check(ok, f"{name}: kernel forward disagrees with the plain forward")

    # retrieval: one user against 10^6 candidates
    n_cand = shapes["retrieval_cand"].dim("n_candidates")
    gen = torch.Generator(device=device).manual_seed(3)
    cand = torch.randn((n_cand, d), generator=gen, device=device) / math.sqrt(d)
    query = {"dense": torch.as_tensor(requests["serve_p99"][0]["dense"][:1], device=device)}
    t0 = time.perf_counter()
    vals, idx = dlrm.retrieval_step(params, query, cand, top_k=100)
    torch.cuda.synchronize()
    t_ret = time.perf_counter() - t0
    bot_cpu = [{k: v.cpu() for k, v in p.items()} for p in params["bot"]]
    user = mlp_apply(bot_cpu, query["dense"].cpu(), final_act=True)
    cvals, cidx = torch.topk(cand.cpu() @ user[0], 100)
    ok = bool(torch.allclose(vals.cpu(), cvals, rtol=DLRM_RTOL, atol=DLRM_ATOL))
    same = set(idx.tolist()) == set(cidx.tolist())
    log(f"[dlrm] retrieval_step over {n_cand} candidates: {t_ret * 1e3:.3f} ms "
        f"(host clock, first call); top-100 scores vs the CPU allclose={ok}, "
        f"same top-100 set={same}")
    check(ok, "retrieval scores disagree with the CPU's")
    del cand

    # the bag kernel on independent zipf ids over the whole table
    rng = np.random.default_rng(7)
    offsets = dlrm.table_offsets(cfg)
    Bz = 16384
    cols = [np.minimum((v * rng.random((Bz, cfg.multi_hot)) ** 3.0).astype(np.int64),
                       v - 1) + offsets[f] for f, v in enumerate(cfg.vocab_sizes)]
    zipf = torch.as_tensor(np.stack(cols, axis=1).reshape(-1, cfg.multi_hot)
                           .astype(np.int32), device=device)
    table = params["embedding"]
    out = embedding_bag(table, zipf)
    ref = embedding_bag_reference(table, zipf)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    ok = bool(torch.allclose(out, ref, rtol=BAG_RTOL, atol=BAG_ATOL))
    zipf_ms = _time_ms(torch, lambda: embedding_bag(table, zipf), 10)
    log(f"[dlrm] embedding_bag on independent zipf ids over the whole table "
        f"(bags {zipf.shape[0]}, H={cfg.multi_hot}, distinct rows "
        f"{_unique_rows(torch, zipf, V)}, max row id {int(zipf.max())}): "
        f"max_abs_err={err:.3e} allclose(rtol={BAG_RTOL}, atol={BAG_ATOL})={ok}; "
        f"{zipf_ms:.4f} ms per launch")
    check(ok, "embedding_bag disagrees with its plain version on zipf ids")
    worst = max(worst, err)
    del zipf, out, ref

    # the kernel at serve_bulk's shapes: the last bulk request's ids
    ids = last["serve_bulk"][0]["sparse"].reshape(-1, cfg.multi_hot)
    ms = _time_ms(torch, lambda: embedding_bag(table, ids), 10)
    plain_ms = _time_ms(torch, lambda: embedding_bag_reference(table, ids), 3)
    lib = lambda: torch.nn.functional.embedding_bag(ids, table, mode="sum")  # noqa: E731
    library_ms = _time_ms(torch, lib, 10)
    lib_err = float((lib() - embedding_bag(table, ids)).abs().max())
    rows = _unique_rows(torch, ids, V)
    nb, H = ids.shape
    bytes_moved = 4 * (nb * H + rows * d + nb * d)
    flops = nb * H * d
    bound_ms, bound_by = _bound(bytes_moved, flops)
    log(f"[dlrm] embedding_bag at serve_bulk (bags {nb}, H={H}, d={d}, distinct "
        f"rows {rows}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"F.embedding_bag {library_ms:.4f} ms (max diff to the kernel "
        f"{lib_err:.3e}), bound {bound_ms:.4f} ms by {bound_by} "
        f"({bytes_moved} B, {flops} FLOP); peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return dict(launches=counts["embedding_bag"], ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                err=worst)


# ---------------------------------------------------------------------------
# phase 7: TAPER's embedding-row placement
# ---------------------------------------------------------------------------


def row_placement(torch, device):
    import dataclasses

    import numpy as np
    import repro_torch.core.visitor as visitor
    from repro_torch.configs.registry import get_config
    from repro_torch.core.taper import Taper, TaperConfig
    from repro_torch.data.recsys import ClickLogPipeline
    from repro_torch.graphs.partition import hash_partition
    from repro_torch.kernels.vm_step.ops import vm_step
    from repro_torch.models.dlrm import coaccess_graph, query_span

    base = get_config("dlrm-rm2")
    cfg = dataclasses.replace(base.reduced(), vocab_sizes=tuple(
        min(v, 1000) for v in base.vocab_sizes))
    pipe = ClickLogPipeline(cfg, batch=1024, seed=0, n_segments=32, p_segment=0.95)
    batches = [next(pipe)["sparse"] for _ in range(4)]
    t0 = time.perf_counter()
    g, row_of_vertex = coaccess_graph(cfg, batches, max_rows_per_field=1000)
    t_graph = time.perf_counter() - t0
    w = _span_workload()
    part0 = hash_partition(g.n, SPAN_K, seed=1)

    def config(**kw):
        return TaperConfig(max_iterations=5, balance_eps=0.2, family_max_size=26,
                           seed=0, **kw)

    timer = _KernelTimer(torch, vm_step)
    visitor.vm_step = timer
    try:
        reset_counts()                              # the path starts here
        t0 = time.perf_counter()
        rep = Taper(g, SPAN_K, config(), device=device).invoke(part0, w)
        t_inv = time.perf_counter() - t0
        counts = read_counts("placement", ["vm_step"])  # ... and ends here
    finally:
        visitor.vm_step = vm_step
    torch.cuda.synchronize()
    kern_ms = [a.elapsed_time(b) for a, b in timer.events]
    t0 = time.perf_counter()
    rep_plain = Taper(g, SPAN_K, config(field_backend="torch"),
                      device=device).invoke(part0, w)
    t_plain = time.perf_counter() - t0
    same = (len(rep.parts) == len(rep_plain.parts)
            and all(np.array_equal(a, b) for a, b in zip(rep.parts, rep_plain.parts)))

    place0 = hash_partition(cfg.total_rows(), SPAN_K, seed=1)
    place1 = place0.copy()
    place1[row_of_vertex] = rep.final_part
    evals = [next(pipe)["sparse"] for _ in range(4)]
    span0 = float(np.mean([query_span(place0, b, SPAN_K) for b in evals]))
    span1 = float(np.mean([query_span(place1, b, SPAN_K) for b in evals]))
    alpha_shape = timer.last_args[0].shape
    log(f"[placement] co-access graph n={g.n} undirected edges={g.m // 2} "
        f"({t_graph:.2f} s host), trie nodes {alpha_shape[1]}, k={SPAN_K}")
    log(f"[placement] invocation {t_inv:.2f} s: {rep.iterations} iterations, "
        f"{rep.total_moves} moves, field {sum(rep.field_seconds):.3f} s "
        f"(kernel {sum(kern_ms):.3f} ms over {len(kern_ms)} launches, "
        f"{min(kern_ms):.4f}-{max(kern_ms):.4f} ms each), swap "
        f"{sum(rep.swap_seconds):.3f} s; plain-field invocation {t_plain:.2f} s; "
        f"partitions equal to the plain field's: {same}")
    log(f"[placement] query span over 4 x 1024 requests: hash {span0!r} -> TAPER "
        f"{span1!r} (reduction {1 - span1 / span0:.4f}); the JAX package's flow "
        f"gives {SPAN_REFERENCE[0]!r} -> {SPAN_REFERENCE[1]!r}")
    check(same, "placement: the kernel field's partitions differ from the "
                "plain field's")
    check((span0, span1) == SPAN_REFERENCE,
          f"placement spans {(span0, span1)} differ from the reference's "
          f"{SPAN_REFERENCE}")
    # the kernel at the path's shapes: its last launch's arguments
    return dict(launches=counts["vm_step"],
                **_vm_at_path_shapes(torch, "placement", timer.last_args))


# ---------------------------------------------------------------------------
# phase 8: GCN inference at ogb_products
# ---------------------------------------------------------------------------


def gcn_inference(torch, device):
    import repro_torch.models.gnn.gcn as gcn
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.configs.registry import get_config
    from repro_torch.data.graphs import batch_to_device, random_graph_batch
    from repro_torch.kernels.segment_spmm.kernel import segment_spmm_cuda
    from repro_torch.kernels.segment_spmm.ops import segment_spmm_csr
    from repro_torch.kernels.segment_spmm.ref import segment_spmm_csr_reference
    from repro_torch.models.gnn import api

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("gcn-cora")
    shape = [s for s in GNN_SHAPES if s.name == "ogb_products"][0]
    t0 = time.perf_counter()
    host = random_graph_batch(cfg, shape, seed=0)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch = batch_to_device(host, device)
    del host
    params = api.init(cfg, shape, seed=0, device=device)
    csr = gcn.graph_csr(batch)
    torch.cuda.synchronize()
    t_up = time.perf_counter() - t0
    n, E = batch["node_feat"].shape[0], batch["edge_src"].shape[0]
    log(f"[gcn] {cfg.name} on {shape.name}: n={n} E={E} d_feat="
        f"{batch['node_feat'].shape[1]} classes={cfg.n_classes}; graph generated "
        f"in {t_gen:.2f} s (host), uploaded + CSR built in {t_up:.2f} s")

    timer = _KernelTimer(torch, segment_spmm_csr)
    gcn.segment_spmm_csr = timer
    lat = []
    try:
        reset_counts()                              # the path starts here
        for _ in range(GCN_FORWARDS):
            t0 = time.perf_counter()
            logits = gcn.forward(params, batch, cfg, csr=csr)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
        counts = read_counts("gcn", ["segment_spmm"])  # ... and ends here
    finally:
        gcn.segment_spmm_csr = segment_spmm_csr
    check(counts["segment_spmm"] == 2 * GCN_FORWARDS, "two launches per forward")
    check(logits.shape == (n, cfg.n_classes) and bool(torch.isfinite(logits).all()),
          "gcn logits: shape or non-finite values")
    per_launch = timer.ms_by_shape()
    for key, ms in per_launch.items():
        log(f"[gcn] segment_spmm at x {key[0]}: ms per launch {[round(x, 4) for x in ms]}")
    log(f"[gcn] forward (host clock, synchronised) s {[round(x, 4) for x in lat]}")

    # kernel forward against plain forward (the plain SpMM takes the edges in
    # chunks of 2^22, so its message tensor stays at 1.7 GB)
    gcn.segment_spmm_csr = lambda x, csr, w: segment_spmm_csr_reference(  # noqa: E731
        x, csr.row_ptr, csr.src, w)
    try:
        plain = gcn.forward(params, batch, cfg, csr=csr)
    finally:
        gcn.segment_spmm_csr = segment_spmm_csr
    torch.cuda.synchronize()
    err = float((logits - plain).abs().max())
    ok = bool(torch.allclose(logits, plain, rtol=GCN_RTOL, atol=GCN_ATOL))
    log(f"[gcn] kernel forward vs plain forward (whole graph): max_abs_err={err:.3e} "
        f"allclose(rtol={GCN_RTOL}, atol={GCN_ATOL})={ok}; predicted-class "
        f"histogram {torch.bincount(logits.argmax(-1), minlength=cfg.n_classes).tolist()}")
    check(ok, "gcn kernel forward disagrees with the plain forward")

    # each launch shape of the path: kernel, plain, library, bound
    out = None
    for key, args in sorted(timer.args_by_shape.items(), key=lambda kv: -kv[0][0][1]):
        x, csr, w = args
        row_ptr, src = csr.row_ptr, csr.src
        F = x.shape[1]
        # the kernel alone, and through the wrapper (host-side checks only:
        # the CSR was checked once, when it was built)
        ms = _time_ms(torch, lambda: segment_spmm_cuda(x, row_ptr, src, w), 10)
        wrapper_ms = _time_ms(torch, lambda: segment_spmm_csr(x, csr, w), 10)
        plain_ms = _time_ms(torch, lambda: segment_spmm_csr_reference(x, row_ptr, src, w), 2)
        with warnings.catch_warnings():             # "beta state" notices
            warnings.simplefilter("ignore", UserWarning)
            A = torch.sparse_csr_tensor(row_ptr, src, w, size=(n, n))
        library_ms = _time_ms(torch, lambda: torch.sparse.mm(A, x), 10)
        k_out = segment_spmm_csr(x, csr, w)
        lib_err = float((torch.sparse.mm(A, x) - k_out).abs().max())
        p_err = float((segment_spmm_csr_reference(x, row_ptr, src, w) - k_out).abs().max())
        live = w != 0
        srcs = int(torch.unique(src[live]).numel())
        nnz = int(live.sum())
        bytes_moved = 4 * ((n + 1) + 2 * E + srcs * F + n * F)
        flops = 2 * nnz * F
        bound_ms, bound_by = _bound(bytes_moved, flops)
        log(f"[gcn] segment_spmm at F={F} (n={n}, E={E}, nonzero weights {nnz}, "
            f"distinct sources {srcs}): kernel {ms:.4f} ms (through the wrapper "
            f"{wrapper_ms:.4f} ms), plain {plain_ms:.4f} ms "
            f"(max diff {p_err:.3e}), torch.sparse.mm {library_ms:.4f} ms (max diff "
            f"{lib_err:.3e}), bound {bound_ms:.4f} ms by {bound_by} ({bytes_moved} B, "
            f"{flops} FLOP)")
        check(p_err <= SPMM_ATOL + SPMM_RTOL * float(k_out.abs().max()),
              f"segment_spmm disagrees with its plain version at F={F}")
        del A, k_out
        if out is None:                             # the widest launch: F = 100
            out = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=library_ms, err=max(err, p_err))
    log(f"[gcn] peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    out["launches"] = counts["segment_spmm"]
    return out


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.device import resolve_device

    t_start = time.perf_counter()
    device = resolve_device("cuda")
    dev_line = device_line()
    log(f"[device] {dev_line}; torch {torch.__version__} cuda {torch.version.cuda}")
    build_kernels()
    errs = {"vm_step": kernel_sweep(torch), "embedding_bag": bag_sweep(torch),
            "segment_spmm": spmm_sweep(torch)}
    paper_values(device)
    fig7(torch, device)
    full = full_size(torch, device)
    serve = dlrm_serving(torch, device)
    place = row_placement(torch, device)
    gnn = gcn_inference(torch, device)
    record = {"kernels": [
        # one kernel on two paths, each at its own shapes: the provgen-1M
        # invocation (23-node trie) and the row placement (677-node trie)
        {"name": "vm_step", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/vm_step.cu",
         "replaces": "src/repro/kernels/vm_step/kernel.py:26",
         "launches": full["launches"],
         "max_abs_err": max(errs["vm_step"], full["err"]),
         "ms": full["ms"], "plain_ms": full["plain_ms"],
         "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
         "library_ms": None},
        {"name": "vm_step/placement", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/vm_step.cu",
         "replaces": "src/repro/kernels/vm_step/kernel.py:26",
         "launches": place["launches"],
         "max_abs_err": max(errs["vm_step"], place["err"]),
         "ms": place["ms"], "plain_ms": place["plain_ms"],
         "bound_ms": place["bound_ms"], "bound_by": place["bound_by"],
         "library_ms": None},
        {"name": "embedding_bag", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
         "replaces": "src/repro/kernels/embedding_bag/kernel.py:24",
         "launches": serve["launches"],
         "max_abs_err": max(errs["embedding_bag"], serve["err"]),
         "ms": serve["ms"], "plain_ms": serve["plain_ms"],
         "bound_ms": serve["bound_ms"], "bound_by": serve["bound_by"],
         "library_ms": serve["library_ms"]},
        {"name": "segment_spmm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/segment_spmm.cu",
         "replaces": "src/repro/kernels/segment_spmm/kernel.py:26",
         "launches": gnn["launches"],
         "max_abs_err": max(errs["segment_spmm"], gnn["err"]),
         "ms": gnn["ms"], "plain_ms": gnn["plain_ms"],
         "bound_ms": gnn["bound_ms"], "bound_by": gnn["bound_by"],
         "library_ms": gnn["library_ms"]},
    ]}
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(dev_line)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
