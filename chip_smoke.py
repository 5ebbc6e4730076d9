#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on the machine with the card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit; build the CUDA kernels from the sources
   in the checkout (``nvcc``, ``sm_90a``);
2. the ``vm_step`` kernel against its plain PyTorch version on the card,
   over seeded shapes (trie sizes 16/23/32/48, 3 and 12 labels, empty rows,
   a hub row of more than 10k in-edges, all-cut weights, up to 100k rows);
3. the paper's worked-example values through ``backend="cuda"``;
4. fig7 at N=2000 on the card (provgen and musicbrainz, hash start): the
   final ipt within 1% of the reference's;
5. the main path at the paper's ProvGen scale: one ``Taper.invoke`` on
   ``provgen_like(1_000_000)``, k=8, PQ1-4, kernel field, with per-iteration
   field/kernel/swap times, a bitwise repeat of the field, and the kernel's
   time, bound and plain-version time at those shapes.

The line before the last is the ``kernels`` JSON record; the last line is
``{"ok": true, "device": {...}}``.  The script imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: fig7 at N=2000 (benchmarks/fig7_convergence.py, BENCH_PR5..PR10.json)
FIG7_FINAL = {"provgen": 908300, "musicbrainz": 96536}
FIG7_TOL = 0.01
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


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*args):
    print(*args, flush=True)


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


def _csr_case(torch, rng, n, e, N, L, hub=0, cut_frac=0.5, empty_frac=0.1,
              device="cuda"):
    """Seeded dst-sorted CSR inputs: rows in ``empty_frac`` get no edges,
    ``hub`` edges all point at row 1, ``cut_frac`` of the weights are 0."""
    import numpy as np

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
        T=t((rng.random((L, N, N)) / N).astype(np.float32), torch.float32),
        row_ptr=t(row_ptr, torch.int32), src=t(src, torch.int32),
        w=t(w, torch.float32), row_label=t(rng.integers(0, L, n), torch.int32),
        dst=t(dst, torch.int64))


def _plain(torch, c):
    from repro_torch.kernels.vm_step.ref import vm_step_reference

    n = c["alpha"].shape[0]
    return vm_step_reference(c["alpha"], c["T"], c["src"].long(), c["dst"],
                             c["w"], c["row_label"].long()[c["dst"]], n)


def kernel_sweep(torch) -> float:
    import numpy as np
    from repro_torch.kernels.vm_step.ops import vm_step

    cases = [
        # (name, n, e, N, L, hub, cut_frac)
        ("N16-L3", 3000, 20000, 16, 3, 0, 0.5),
        ("N23-L12", 3000, 20000, 23, 12, 0, 0.5),
        ("N32-L3", 3000, 20000, 32, 3, 0, 0.5),
        ("N48-L12-two-cols", 3000, 20000, 48, 12, 0, 0.5),
        ("hub-12k", 20000, 60000, 23, 3, 12000, 0.3),
        ("all-cut", 5000, 30000, 23, 3, 0, 1.0),
        ("n100k-provgen-like", 100_000, 553_000, 23, 3, 0, 0.5),
        ("n100k-musicbrainz-like", 100_000, 553_000, 16, 12, 0, 0.5),
    ]
    worst = 0.0
    for i, (name, n, e, N, L, hub, cut) in enumerate(cases):
        c = _csr_case(torch, np.random.default_rng(100 + i), n, e, N, L,
                      hub=hub, cut_frac=cut)
        out = vm_step(c["alpha"], c["T"], c["row_ptr"], c["src"], c["w"],
                      c["row_label"])
        torch.cuda.synchronize()
        ref = _plain(torch, c)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        ok = bool(torch.allclose(out, ref, rtol=RTOL, atol=ATOL))
        empty = int((c["row_ptr"][1:] == c["row_ptr"][:-1]).sum())
        zero_rows_ok = bool((out[(c["row_ptr"][1:] == c["row_ptr"][:-1])] == 0).all())
        log(f"[kernel] vm_step {name}: n={n} E={e} N={N} L={L} empty_rows={empty} "
            f"max_abs_err={err:.3e} allclose(rtol={RTOL}, atol={ATOL})={ok}")
        check(ok, f"vm_step kernel disagrees with its plain version on {name}")
        check(zero_rows_ok, f"vm_step kernel wrote nonzero rows without edges on {name}")
        check(bool(torch.isfinite(out).all()), f"non-finite kernel output on {name}")
        worst = max(worst, err)
        if name == "n100k-provgen-like":
            # rows of even length: the kernel's cost per local edge without
            # the row-length skew of the main path's graph
            args = (c["alpha"], c["T"], c["row_ptr"], c["src"], c["w"], c["row_label"])
            ms = _time_ms(torch, lambda: vm_step(*args), 20)
            nz = int((c["w"] != 0).sum())
            log(f"[kernel] vm_step {name} timing: {ms:.4f} ms, "
                f"{ms * 1e6 / nz:.3f} ns per local edge ({nz} local edges, "
                f"longest row {int((c['row_ptr'][1:] - c['row_ptr'][:-1]).max())})")
        del c, out, ref
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
        check(abs(final - want) <= FIG7_TOL * want,
              f"fig7 {name}: final ipt {final} not within 1% of {want}")
        # the kernel field against the plain field on the CPU, same state
        arrays = TPSTry.from_workload(w).compile(g.label_names)
        fc = extroversion_field(g, arrays, start, 8, backend="cuda", device=device)
        fp = extroversion_field(g, arrays, start, 8, backend="torch", device="cpu")
        same = all(np.array_equal(getattr(fc, k), getattr(fp, k))
                   for k in ("alpha", "pr", "edge_mass", "extro_mass",
                             "extroversion", "ext_to"))
        log(f"[fig7] {name} cuda field (card) == torch field (CPU) bitwise: {same}")
        for k in ("alpha", "edge_mass", "pr", "extro_mass"):
            check(np.allclose(getattr(fc, k), getattr(fp, k), rtol=RTOL, atol=ATOL),
                  f"fig7 {name}: cuda field {k} disagrees with the CPU field")


# ---------------------------------------------------------------------------
# phase 5: the main path at full size
# ---------------------------------------------------------------------------


class _KernelTimer:
    """Records CUDA events around every ``vm_step`` call the field makes
    (no synchronisation); the wrapper's own launch count is untouched."""

    def __init__(self, torch, fn):
        self.torch, self.fn, self.events, self.last_args = torch, fn, [], None

    def __call__(self, *args):
        ev0 = self.torch.cuda.Event(enable_timing=True)
        ev1 = self.torch.cuda.Event(enable_timing=True)
        ev0.record()
        out = self.fn(*args)
        ev1.record()
        self.events.append((ev0, ev1))
        self.last_args = args
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
    from repro_torch.kernels.vm_step.ref import vm_step_reference
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
        vm_step.launches = 0                        # main path starts here
        t0 = time.perf_counter()
        rep = taper.invoke(part0, w)
        t_inv = time.perf_counter() - t0
        launches = vm_step.launches                 # ... and ends here
    finally:
        visitor.vm_step = vm_step
    torch.cuda.synchronize()
    check(launches > 0, "the main path launched no vm_step kernel")
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
    for k in ("alpha", "edge_mass", "pr", "extro_mass"):
        check(np.allclose(getattr(f1, k), getattr(fp, k), rtol=RTOL, atol=ATOL),
              f"full-size cuda field {k} disagrees with the plain field")

    # the kernel at the main path's shapes: its last launch's arguments
    args = timer.last_args
    alpha, T, row_ptr, src, wt, row_label = args
    n, N = alpha.shape
    L, E = T.shape[0], src.shape[0]
    ms = _time_ms(torch, lambda: vm_step(*args), 20)
    dst = torch.repeat_interleave(torch.arange(n, device=alpha.device),
                                  (row_ptr[1:] - row_ptr[:-1]).long())
    dlab = row_label.long()[dst]
    src64 = src.long()
    plain_ms = _time_ms(torch, lambda: vm_step_reference(alpha, T, src64, dst, wt,
                                                         dlab, n), 3)
    out_k = vm_step(*args)
    out_p = vm_step_reference(alpha, T, src64, dst, wt, dlab, n)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    check(bool(torch.allclose(out_k, out_p, rtol=RTOL, atol=ATOL)),
          "vm_step kernel disagrees with its plain version at full size")
    nz = int((wt != 0).sum())
    deg = (row_ptr[1:] - row_ptr[:-1]).long()
    rows = torch.repeat_interleave(torch.arange(n, device=deg.device), deg)
    local_deg = torch.bincount(rows[wt != 0], minlength=n)
    log(f"[full] vm_step rows: longest row {int(deg.max())} edges "
        f"({int(local_deg.max())} local); mean {E / n:.2f} edges "
        f"({nz / n:.2f} local); {ms * 1e6 / nz:.3f} ns per local edge")
    bytes_moved = 4 * ((n + 1) + 2 * E + n + 2 * n * N + L * N * N)
    flops = nz * (2 * N * N + 2 * N)
    bound_s = max(bytes_moved / PEAK_BYTES_S, flops / PEAK_F32_FLOPS)
    bound_by = "bytes" if bytes_moved / PEAK_BYTES_S >= flops / PEAK_F32_FLOPS else "operations"
    log(f"[full] vm_step at n={n} E={E} N={N} L={L} (local edges {nz}): kernel "
        f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_s * 1e3:.4f} ms "
        f"by {bound_by} ({bytes_moved} B, {flops} FLOP), max_abs_err {err:.3e}")
    return dict(launches=launches, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_s * 1e3, bound_by=bound_by, err=err)


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
    worst = kernel_sweep(torch)
    paper_values(device)
    fig7(torch, device)
    full = full_size(torch, device)
    record = {"kernels": [{
        "name": "vm_step",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/vm_step.cu",
        "replaces": "src/repro/kernels/vm_step/kernel.py:26",
        "launches": full["launches"],
        "max_abs_err": max(worst, full["err"]),
        "ms": full["ms"],
        "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"],
        "bound_by": full["bound_by"],
        "library_ms": None,
    }]}
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(dev_line)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
