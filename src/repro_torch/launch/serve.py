"""Serving launcher: online RPQ query service with TAPER maintenance.

    PYTHONPATH=src python -m repro_torch.launch.serve --dataset provgen --ticks 10
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

The JAX package's launcher with its flags (``--dataset``, ``--n``, ``--k``,
``--ticks``, ``--batch``), its queries and its tick log, and ``--device``:
the card by default, as every entry point of the port, where the
``GraphQueryEngine``'s invocations evaluate the field through the
``vm_step`` kernel (``TaperConfig.field_backend=None`` resolves to the
device's rung).  ``main`` returns each tick's record.
"""
from __future__ import annotations

import argparse
from typing import Dict, List

from repro_torch.core.rpq import parse_rpq
from repro_torch.graphs.generators import musicbrainz_like, provgen_like
from repro_torch.graphs.partition import hash_partition
from repro_torch.serve.engine import GraphQueryEngine, ServeConfig
from repro_torch.utils import get_logger
from repro_torch.workload.stream import WorkloadStream

log = get_logger("launch.serve")

QUERIES = {
    "provgen": ["Entity.Entity.Entity", "Agent.Activity.Entity",
                "Entity.Activity.Agent"],
    "musicbrainz": ["Artist.Credit.Track.Medium",
                    "Artist.Credit.(Track|Recording).Credit.Artist",
                    "Area.Artist.(Artist|Label).Area"],
}


def main(argv=None) -> List[Dict]:
    """Serve ``--ticks`` batches of ``--batch`` requests drawn from a
    drifting stream; returns ``[{"tick", "ipt_per_request", "invocations",
    "drift"}]``, one record a tick."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", choices=["provgen", "musicbrainz"],
                    default="provgen")
    ap.add_argument("--n", type=int, default=8000)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--ticks", type=int, default=10)
    ap.add_argument("--batch", type=int, default=100)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' to run here)")
    args = ap.parse_args(argv)

    g = (provgen_like if args.dataset == "provgen" else musicbrainz_like)(
        args.n, seed=3)
    queries = [parse_rpq(q) for q in QUERIES[args.dataset]]
    stream = WorkloadStream(queries, period=float(args.ticks), seed=0)
    engine = GraphQueryEngine(
        g, hash_partition(g.n, args.k, seed=1), args.k,
        ServeConfig(min_requests_between_invocations=3 * args.batch),
        device=args.device)

    records = []
    for tick in range(args.ticks):
        results = engine.serve_batch(stream.sample(args.batch))
        ipt = sum(r.ipt for r in results) / len(results)
        s = engine.stats()
        log.info("tick %d: ipt/request=%.2f invocations=%d drift=%.3f",
                 tick, ipt, s["invocations"], s["drift"])
        records.append({"tick": tick, "ipt_per_request": ipt,
                        "invocations": s["invocations"], "drift": s["drift"]})
        stream.advance(1.0)
    log.info("served %d requests total, %.2f ipt/request",
             engine.stats()["requests"], engine.stats()["ipt_per_request"])
    return records


if __name__ == "__main__":
    main()
