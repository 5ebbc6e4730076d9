"""Readings that set the limits of ``checks/<cell>.json``: the program's and
the control's, at a cell's own size, on several seeds in one process.

    python3 portbench/control.py --config <name> --traffic <mix> [<mix> ...] \
        --seeds <n> [<n> ...] [--calls 2] [--n <vertices>]

For each seed it makes the cell's graph, builds the program once, and calls
``Taper.field`` on the first ``--calls`` partitionings that a run of that
seed draws for each mix.  The plain reference then computes each field in
float64, and again in bfloat16, the nearest precision below the float32 that
the configuration states: the control.  Both the program's field and the
control's are compared with the float64 reference as a run compares them,
and judged by the cell's limits.  One JSON line per seed and mix; the runs of
the benchmark itself never run this.  ``--n`` shrinks the graph (tests).
"""
from __future__ import annotations

import sys

if __name__ == "__main__" and sys.path and sys.path[0]:
    import os.path

    if os.path.realpath(sys.path[0]) == os.path.dirname(os.path.realpath(__file__)):
        sys.path.pop(0)

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def cell_of(bench: Dict, config: str, traffic: str) -> str:
    for w in bench["workloads"]:
        if w["config"] == config and w["traffic"] == traffic:
            return w["name"]
    raise KeyError(f"no cell of configuration {config!r} under traffic {traffic!r}")


def readings(bench: Dict, config: str, mixes: List[str], seed: int, calls: int, device,
             n: Optional[int] = None) -> List[Dict]:
    """For each mix: the program's and the control's merged numbers over
    ``calls`` calls of ``seed``, and whether the cell's limits pass each."""
    import torch

    from portbench import cell, compare, loadgen, registry
    from portbench.reference import field as ref_field
    from portbench.reference import trie as ref_trie

    cfg = registry.config(bench, config)
    if n is not None:
        cfg["graph"]["n"] = n
    k, dense = int(cfg["k"]), bool(cfg["dense_ext_to"])
    labels, edges = cell.make_data(cfg, seed, device)
    seeds = cell.sub_seeds(seed)
    parts, results, prog = {}, {}, None
    t0 = time.perf_counter()
    for mix_name in mixes:
        mix = registry.traffic(mix_name)
        start = loadgen.start_partition(mix, labels, k, seed)
        if prog is None:
            prog = cell.build_program(cfg, labels, edges, start, device)
        draws = loadgen.Draws(start, k, float(mix["move_frac"]), seeds["moves"], device)
        parts[mix_name] = [draws.next().cpu().numpy() for _ in range(calls)]
        results[mix_name] = [prog.taper.field(p, prog.trie) for p in parts[mix_name]]
    program_s = time.perf_counter() - t0
    trie_prog = prog.trie
    del prog
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    names = list(cfg["graph"]["labels"])
    rtrie = ref_trie.build(cfg["workload"], int(cfg["star_max"]))
    graph = ref_field.build_graph(int(cfg["graph"]["n"]), labels, edges, len(names), device)
    label_ids = {s: i for i, s in enumerate(names)}
    prog_paths = compare.column_paths(trie_prog.parent, trie_prog.label, names)
    out = []
    for mix_name in mixes:
        name = cell_of(bench, config, mix_name)
        limits = registry.checks(name)["limits"]
        prog_r, ctrl_r = [], []
        for part, result in zip(parts[mix_name], results[mix_name]):
            ref = ref_field.field(graph, rtrie, label_ids, part, k, dense, torch.float64)
            prog_r.append(compare.compare(result, ref, prog_paths, rtrie.paths, dense))
            low = ref_field.field(graph, rtrie, label_ids, part, k, dense, torch.bfloat16)
            ctrl_r.append(compare.compare(SimpleNamespace(**low), ref, rtrie.paths,
                                          rtrie.paths, dense))
            del ref, low
        prog_n, ctrl_n = compare.merge(prog_r), compare.merge(ctrl_r)
        for nums in (prog_n, ctrl_n):
            nums["failed_calls"] = 0.0
        prog_ok = all(v["ok"] for v in compare.judge(prog_n, limits).values())
        ctrl_ok = all(v["ok"] for v in compare.judge(ctrl_n, limits).values())
        out.append({"cell": name, "seed": seed, "calls": calls, "n": int(cfg["graph"]["n"]),
                    "program": prog_n, "program_passes": prog_ok,
                    "control": ctrl_n, "control_passes": ctrl_ok,
                    "program_s": program_s})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", nargs="+", required=True)
    ap.add_argument("--seeds", nargs="+", type=int, required=True)
    ap.add_argument("--calls", type=int, default=2)
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench import registry

    bench = registry.load_benchmark(ROOT)
    for seed in args.seeds:
        for line in readings(bench, args.config, args.traffic, seed, args.calls,
                             torch.device(args.device), n=args.n):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
