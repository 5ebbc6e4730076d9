#!/usr/bin/env python3
"""Time the port's musicbrainz-like graph generator.

    PYTHONPATH=src python3 tools/generator_time.py 1000000 3000000
    PYTHONPATH=src python3 tools/generator_time.py 10000000 --unique

For each n, the seconds of ``repro_torch.graphs.generators.
musicbrainz_like(n, seed=0)`` and the graph's directed edges.  With
``--unique``, also the seconds of ``np.unique`` over as many random int64
keys as the last graph has directed edges, beside the sort and cut that
``LabelledGraph.from_undirected_edges`` uses instead (numpy 2's
``np.unique`` of integers goes through a hash table).  Prints the numpy
version and the CPU model; runs on the host only.
"""
from __future__ import annotations

import argparse
import platform
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def cpu_model() -> str:
    try:
        for line in open("/proc/cpuinfo"):
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or "unknown"


def main(argv=None) -> int:
    from repro_torch.graphs.generators import musicbrainz_like

    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int, nargs="+")
    ap.add_argument("--unique", action="store_true")
    args = ap.parse_args(argv)
    print(f"numpy {np.__version__}; {cpu_model()}", flush=True)
    m = 0
    for n in args.n:
        t0 = time.perf_counter()
        g = musicbrainz_like(n, seed=0)
        m = g.m
        print(f"musicbrainz_like({n}): {time.perf_counter() - t0:.2f} s, m={m}", flush=True)
        del g
    if args.unique:
        keys = np.random.default_rng(0).integers(0, 2 ** 46, m)
        t0 = time.perf_counter()
        want = np.unique(keys)
        t_unique = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = np.sort(keys)
        got = got[np.concatenate([[True], got[1:] != got[:-1]])]
        t_cut = time.perf_counter() - t0
        assert np.array_equal(got, want)
        print(f"{m} int64 keys: np.unique {t_unique:.2f} s, sort and cut {t_cut:.2f} s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
