#!/usr/bin/env python3
"""Two sets of dry-run records side by side: per device, args + temp GB and
each collective's count and GB.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k \\
        --mesh both --out BEFORE          # in the other checkout
    PYTHONPATH=src python -m repro_torch.launch.dryrun ... --out AFTER
    python3 tools/dryrun_compare.py BEFORE AFTER [--match train_4k]

Reads ``launch/dryrun.py``'s JSON records (``ARCH__SHAPE__MESH.json``) of
both directories and prints a markdown table of the records both hold
whose name contains ``--match``: each record's status, ``argument_size``
+ ``temp_size`` (``memory_analysis``) and collectives (AG all-gather, AR
all-reduce, RS reduce-scatter, A2A all-to-all: count and GB), before and
after, and the change in temp.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

SHORT = {"all-gather": "AG", "all-reduce": "AR", "reduce-scatter": "RS", "all-to-all": "A2A"}


def summary(rec) -> str:
    if rec.get("status") != "ok":
        return f"{rec.get('status')}: {str(rec.get('error'))[:80]}"
    ma, col = rec["memory_analysis"], rec["collectives"]
    parts = [f"{SHORT.get(op, op)} {n} ({col['bytes_by_op'].get(op, 0.0) / 1e9:.2f})"
             for op, n in sorted(col["count_by_op"].items())]
    return (f"{ma['argument_size_in_bytes'] / 1e9:.2f} + {ma['temp_size_in_bytes'] / 1e9:.2f}; "
            + ", ".join(parts))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("before", type=Path)
    ap.add_argument("after", type=Path)
    ap.add_argument("--match", default="")
    a = ap.parse_args(argv)
    print("| record | before: args + temp GB; collectives, count (GB) | after | temp change GB |")
    print("| --- | --- | --- | --- |")
    for path in sorted(a.before.glob("*.json")):
        other = a.after / path.name
        if a.match not in path.stem or not other.exists():
            continue
        b, c = (json.loads(p.read_text()) for p in (path, other))
        change = ""
        if b.get("status") == c.get("status") == "ok":
            temps = [r["memory_analysis"]["temp_size_in_bytes"] for r in (b, c)]
            change = f"{(temps[1] - temps[0]) / 1e9:+.2f}"
        print(f"| {path.stem.replace('__', ' ')} | {summary(b)} | {summary(c)} | {change} |")


if __name__ == "__main__":
    main()
