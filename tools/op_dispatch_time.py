#!/usr/bin/env python3
"""Host time of a kernel wrapper's call by its two routes.

    PYTHONPATH=src python3 tools/op_dispatch_time.py --device cpu
    PYTHONPATH=src python3 tools/op_dispatch_time.py --device cuda

A wrapper sends plain CPU and CUDA tensors straight to the kernel (or its
plain version) and fake tensors and DTensors through its custom op
(``repro_torch::<name>``, ``kernels.traced``).  For ``vm_step`` and
``segment_spmm_csr`` at a small serving shape (2,000 rows, 12,000 edges,
23 trie columns / 16 features), this prints the microseconds a call of
each: ``traced()`` alone, the wrapper (the direct route), and the custom op
on the same plain tensors.  Calls are issued back to back and the device
synchronised once at the end, so on the card the numbers are the host's
issue time wherever it exceeds the kernel's.  Prints the device line.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def device_line(device: str) -> str:
    if device != "cuda":
        return "the host's CPU"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def per_call_us(fn, torch, device: str, calls: int, repeats: int) -> float:
    """The median over ``repeats`` of the microseconds a call of ``fn``."""
    fn()
    times = []
    for _ in range(repeats):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        if device == "cuda":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    import torch

    from repro_torch.kernels import traced
    from repro_torch.kernels.segment_spmm.ops import EdgeCSR, segment_spmm_csr
    from repro_torch.kernels.vm_step.ops import vm_step
    from repro_torch.kernels.vm_step.ref import transition_columns

    if args.device == "cuda" and not torch.cuda.is_available():
        print("op_dispatch_time: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device(args.device)
    rng = np.random.default_rng(0)
    n, e, N, L, F = 2000, 12000, 23, 4, 16
    parent = np.r_[-1, rng.integers(0, np.arange(1, N))].astype(np.int32)
    par, val = transition_columns(parent, rng.integers(0, L, N), rng.random(N), L)
    dst = np.sort(rng.integers(0, n, e))
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n), out=row_ptr[1:])
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    alpha, x = t(rng.random((n, N)), torch.float32), t(rng.random((n, F)), torch.float32)
    par_t, val_t = t(par, torch.int32), t(val, torch.float32)
    csr = EdgeCSR(row_ptr=t(row_ptr, torch.int32), src=t(rng.integers(0, n, e), torch.int32),
                  order=t(np.arange(e), torch.int64))
    w, lab = t(rng.random(e), torch.float32), t(rng.integers(0, L, n), torch.int32)
    ops = torch.ops.repro_torch
    cases = {
        "traced() on 7 tensors": lambda: traced(alpha, par_t, val_t, csr.row_ptr, csr.src, w, lab),
        "vm_step wrapper (direct)": lambda: vm_step(alpha, par_t, val_t, csr, w, lab),
        "vm_step custom op": lambda: ops.vm_step(alpha, par_t, val_t, csr.row_ptr, csr.src, w,
                                                 lab, csr.plan.runs, csr.plan.long_rows),
        "segment_spmm_csr wrapper (direct)": lambda: segment_spmm_csr(x, csr, w),
        "segment_spmm custom op": lambda: ops.segment_spmm(x, csr.row_ptr, csr.src, w, False),
    }
    calls = args.calls if args.device == "cuda" else max(1, args.calls // 20)
    for name, fn in cases.items():
        us = per_call_us(fn, torch, args.device, calls, args.repeats)
        print(f"[dispatch] {name}: {us:.2f} us a call ({calls} calls, median of "
              f"{args.repeats}); {device_line(args.device)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
