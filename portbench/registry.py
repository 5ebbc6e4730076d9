"""Everything the harness finds by name.

``BENCHMARK.json`` at the checkout's root names the cells, configurations and
metrics.  Each piece lives in a file of its own, found from its name:

  configuration     the ``file`` that ``BENCHMARK.json`` gives it (``configs/<name>.json``)
  traffic mix       ``traffic/<name>.json``, read by ``loadgen.py``
  cell's checks     ``checks/<cell>.json``: how many calls are compared and each limit
  metric            ``metrics/<name>.py``, whose ``read(run)`` gives the value or None
  peaks             ``peaks.json``, by the name the card reports

So a new configuration, mix, cell or metric is a new file and an entry in
``BENCHMARK.json``; no file of the harness changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries: List[Dict], name: str, what: str) -> Dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def workload(bench: Dict, name: str) -> Dict:
    return _by_name(bench["workloads"], name, "workload")


def config(bench: Dict, name: str, root: Path = ROOT) -> Dict:
    entry = _by_name(bench["configs"], name, "configuration")
    with open(root / entry["file"]) as f:
        return json.load(f)


def _json(sub: str, name: str, here: Path) -> Dict:
    with open(here / sub / f"{name}.json") as f:
        return json.load(f)


def traffic(name: str, here: Path = HERE) -> Dict:
    return _json("traffic", name, here)


def checks(cell: str, here: Path = HERE) -> Dict:
    return _json("checks", cell, here)


def peaks(device_kind: str, here: Path = HERE) -> Optional[Dict]:
    with open(here / "peaks.json") as f:
        return json.load(f).get(device_kind)


def reader(metric: str, here: Path = HERE) -> Callable:
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = here / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + "".join(c if c.isalnum() else "_" for c in metric), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(f"no reader for metric {metric!r} at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of(bench: Dict, cell: str, traced: bool) -> List[Dict]:
    """The cell's metrics: its end-to-end ones untraced, its per-layer ones
    traced; a metric with ``workloads`` only in the cells it lists."""
    entries = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]
