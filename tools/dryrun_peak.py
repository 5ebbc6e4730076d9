#!/usr/bin/env python3
"""What is alive at a dry-run cell's peak of temporaries.

    PYTHONPATH=src python3 tools/dryrun_peak.py olmoe-1b-7b train_4k single
    PYTHONPATH=src python3 tools/dryrun_peak.py qwen3-4b train_4k multi --top 10

Runs the cell as ``launch/dryrun.py`` does (fake tensors over a fake
process group of 256 or 512 ranks) and, at the moment the storages
allocated during the step peak (``memory_analysis.temp_size_in_bytes``),
lists the live ones by the port's line that made them (the innermost frame
under ``repro_torch/models`` or ``repro_torch/train``), the op, the local
shape and the dtype, largest first, with their sum.  One device's view;
nothing is allocated for real.
"""
from __future__ import annotations

import argparse
import collections
import sys
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _made_at() -> str:
    for fr in reversed(traceback.extract_stack(limit=80)):
        for part in ("repro_torch/models/", "repro_torch/train/"):
            if part in fr.filename:
                return f"{fr.filename.split('repro_torch/')[1]}:{fr.lineno}"
    return "?"


def peak_storages(arch: str, shape: str, multi_pod: bool):
    """``(peak bytes, [(made at, op, shape, dtype, bytes), ...])`` of the
    storages alive at the cell's peak."""
    from repro_torch.launch import dryrun, hlo_analysis
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import build_cell

    mode = hlo_analysis.CountingMode
    made, now, at_peak = {}, {}, [[]]
    allocated, dispatch = mode._allocated, mode.__torch_dispatch__

    def tracked_allocated(self, t):
        key = id(t.untyped_storage())
        fresh = key not in self._args and key not in self._live
        peak = self.peak_bytes
        allocated(self, t)
        if fresh and key in self._live:
            made[key] = (_made_at(), str(now.get("op")), tuple(t.shape), str(t.dtype),
                         self._live[key][1])
        if self.peak_bytes > peak:
            at_peak[0] = [made[k] for k in self._live if k in made]

    def tracked_dispatch(self, func, types, args=(), kwargs=None):
        now["op"] = func
        return dispatch(self, func, types, args, kwargs)

    mode._allocated, mode.__torch_dispatch__ = tracked_allocated, tracked_dispatch
    try:
        dryrun.fake_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        build_cell(arch, shape, mesh).lower()
    finally:
        mode._allocated, mode.__torch_dispatch__ = allocated, dispatch
    return sum(s[4] for s in at_peak[0]), at_peak[0]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("mesh", choices=("single", "multi"))
    ap.add_argument("--top", type=int, default=12)
    a = ap.parse_args(argv)
    total, live = peak_storages(a.arch, a.shape, a.mesh == "multi")
    print(f"{a.arch} {a.shape} {a.mesh}: {total / 1e9:.3f} GB alive at the peak "
          f"in {len(live)} storages")
    size, count = collections.Counter(), collections.Counter()
    for at, op, shp, dt, nbytes in live:
        size[(at, op, shp, dt)] += nbytes
        count[(at, op, shp, dt)] += 1
    for (at, op, shp, dt), nbytes in size.most_common(a.top):
        print(f"{nbytes / 1e9:10.3f} GB x{count[(at, op, shp, dt)]:3d}  {at}  {op}  "
              f"{list(shp)} {dt}")


if __name__ == "__main__":
    main()
