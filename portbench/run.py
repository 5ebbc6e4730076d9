"""Run one cell of ``BENCHMARK.json`` on the card and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The system under test is the checkout's
``src/repro_torch``; the run exits with a code other than 0, and prints no
result, where there is no CUDA card (or fewer than the cell asks for), where
the checkout has no program, or where JAX or the JAX package was loaded.
Standard error ends with each compared number beside its limit; standard
output ends with one JSON object.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import sys  # noqa: E402

# run as a script, this file's folder heads the search path: drop it, so the
# harness's modules load only as ``portbench.*``
if __name__ == "__main__" and sys.path and sys.path[0]:
    import os.path

    if os.path.realpath(sys.path[0]) == os.path.dirname(os.path.realpath(__file__)):
        sys.path.pop(0)

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: modules that no run may load (compared by their whole top-level name)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: kernel and compiler caches, at fixed paths inside the checkout
CACHE = ROOT / ".bench_cache"


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _program_importable() -> bool:
    """Whether ``repro_torch`` loads from this checkout's ``src``."""
    try:
        import repro_torch
    except ImportError as exc:
        print(f"portbench: the program does not load: {exc}", file=sys.stderr)
        return False
    where = Path(repro_torch.__file__).resolve()
    if (ROOT / "src") not in where.parents:
        print(f"portbench: repro_torch loads from {where}, not from this checkout",
              file=sys.stderr)
        return False
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench import cell, registry

    bench = registry.load_benchmark(ROOT)
    chips = int(registry.workload(bench, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA card(s), this machine has {have}",
              file=sys.stderr)
        return 2
    if not _program_importable():
        return 2
    out = cell.run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                        torch.device("cuda", 0), T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, v in out["compared"].items():
        print(f"compared {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
