"""Serving metrics / SLO accounting, exported as plain dicts.

Latency and per-request ipt are tracked in bounded sliding windows (the
most recent ``window`` samples) so p50/p99 reflect current behaviour, not
the lifetime average; counters (requests, rejections, invocations, stalls)
are monotonic.  ``ServeMetrics.snapshot()`` is the only export surface —
a flat dict of floats/ints that benchmarks and dashboards can consume
without importing anything from this package."""
from __future__ import annotations

import threading
from typing import Dict, List, Optional


class SlidingWindow:
    """Bounded ring of float samples with exact percentiles over the ring.

    The sorted view is computed lazily and cached until the next
    ``record`` — snapshot paths take 4 percentiles per window, and
    re-sorting the full ring for each was measurable at serving rates."""

    def __init__(self, window: int = 2048):
        self._buf: List[float] = []
        self._pos = 0
        self._window = int(window)
        self._sorted: Optional[List[float]] = None

    def record(self, x: float) -> None:
        if len(self._buf) < self._window:
            self._buf.append(float(x))
        else:
            self._buf[self._pos] = float(x)
            self._pos = (self._pos + 1) % self._window
        self._sorted = None

    def percentile(self, p: float) -> float:
        if not self._buf:
            return 0.0
        s = self._sorted
        if s is None:
            s = self._sorted = sorted(self._buf)
        idx = min(len(s) - 1, max(0, int(round(p / 100.0 * (len(s) - 1)))))
        return s[idx]

    def mean(self) -> float:
        return sum(self._buf) / len(self._buf) if self._buf else 0.0

    def __len__(self) -> int:
        return len(self._buf)


class ServeMetrics:
    """Counters + windows for the serving loop.  All mutators take the
    internal lock, so the worker, invocation and admission threads can
    report concurrently; ``snapshot`` returns a consistent copy."""

    def __init__(self, window: int = 2048):
        self._lock = threading.Lock()
        self.latency = SlidingWindow(window)
        self.request_ipt = SlidingWindow(window)
        self.completed = 0
        self.batches = 0
        self.total_ipt = 0.0
        self.invocations = 0
        #: wall seconds the worker was *blocked* in synchronous invocations
        #: (stop-the-world mode; 0 under full overlap)
        self.invocation_stall_s = 0.0
        #: wall seconds invocations spent in flight concurrently with serving
        self.invocation_overlap_s = 0.0
        #: requests completed while an invocation was in flight
        self.completed_during_invocation = 0
        self.partition_swaps = 0
        self.invocation_failures = 0
        # -- health / degradation -----------------------------------------------
        #: invocations cancelled by the watchdog after exceeding the timeout
        self.watchdog_aborts = 0
        #: times the loop fell one rung down the field-backend ladder
        self.backend_fallbacks = 0
        #: times a recovery probe climbed back up a rung
        self.backend_recoveries = 0
        #: failed device uploads of the sharded packing (_warm_devices)
        self.upload_failures = 0
        self.snapshots_taken = 0
        self.snapshot_failures = 0
        #: WAL batches re-applied at restore (set once by ServingLoop.restore)
        self.replayed_mutations = 0
        # -- batched enumeration -------------------------------------------------
        #: depth expansions executed by the frontier-batched enumerator
        self.enum_sweeps = 0
        #: total live (query, state, tail-vertex) rows those sweeps advanced
        self.frontier_rows = 0
        #: per-executor-worker completed-request counts; the snapshot folds
        #: every worker's contribution into the one flat dict
        self.completed_by_worker: Dict[int, int] = {}

    def record_invocation_failure(self) -> None:
        with self._lock:
            self.invocation_failures += 1

    def record_watchdog_abort(self) -> None:
        with self._lock:
            self.watchdog_aborts += 1

    def record_backend_fallback(self) -> None:
        with self._lock:
            self.backend_fallbacks += 1

    def record_backend_recovery(self) -> None:
        with self._lock:
            self.backend_recoveries += 1

    def record_upload_failure(self) -> None:
        with self._lock:
            self.upload_failures += 1

    def record_snapshot(self, ok: bool = True) -> None:
        with self._lock:
            if ok:
                self.snapshots_taken += 1
            else:
                self.snapshot_failures += 1

    def record_batch(self, latencies, ipts, overlapped: bool,
                     enum_sweeps: int = 0, frontier_rows: int = 0,
                     worker_id: int = 0) -> None:
        with self._lock:
            self.batches += 1
            self.enum_sweeps += int(enum_sweeps)
            self.frontier_rows += int(frontier_rows)
            n = 0
            for lat, ipt in zip(latencies, ipts):
                self.latency.record(lat)
                self.request_ipt.record(float(ipt))
                self.completed += 1
                self.total_ipt += float(ipt)
                n += 1
                if overlapped:
                    self.completed_during_invocation += 1
            self.completed_by_worker[worker_id] = (
                self.completed_by_worker.get(worker_id, 0) + n)

    def record_invocation(self, wall_s: float, overlapped: bool) -> None:
        with self._lock:
            self.invocations += 1
            self.partition_swaps += 1
            if overlapped:
                self.invocation_overlap_s += float(wall_s)
            else:
                self.invocation_stall_s += float(wall_s)

    def snapshot(self, queue_depth: int = 0, ingest_depth: int = 0,
                 rejected_requests: int = 0, rejected_cold_requests: int = 0,
                 rejected_mutations: int = 0, failed_mutations: int = 0,
                 field_stats: Optional[Dict] = None, field_backend: str = "",
                 degraded: bool = False, worker_error: str = "",
                 invocation_error: str = "",
                 journal_seq: int = 0,
                 epoch: int = 0, cluster_epoch: int = 0,
                 fenced_writes: int = 0, fencing_rejections: int = 0,
                 last_stale_epoch: int = -1, fence_error: str = "",
                 snapshot_capture_s: float = 0.0,
                 snapshot_publish_s: float = 0.0,
                 extra: Optional[Dict] = None) -> Dict[str, float]:
        """Flat dict of the current SLO picture (plain python scalars).

        ``extra`` merges caller-provided scalars (the control loops' shed
        level, serve pressure, breaker states) into the flat dict last, so
        new control-plane keys never require a signature change here.

        ``field_stats`` is the sharded field's last measured exchange
        footprint (``pre["_halo_stats"]``): the halo bytes moved per depth
        step, their ratio to a full-field exchange, and which shard-map /
        exchange backend produced them — so dashboards see the serving
        loop's invocation bandwidth next to its latency percentiles."""
        fs = field_stats or {}
        with self._lock:
            c = max(self.completed, 1)
            # flat-dict contract: per-worker completions export as scalar
            # completed_by_worker_<i> keys, never as a nested dict
            by_worker = {f"completed_by_worker_{w}": n
                         for w, n in sorted(self.completed_by_worker.items())}
            return {
                "completed": self.completed,
                "batches": self.batches,
                "rejected_requests": rejected_requests,
                "rejected_cold_requests": rejected_cold_requests,
                "rejected_mutations": rejected_mutations,
                "failed_mutations": failed_mutations,
                "halo_bytes_per_depth": fs.get("halo_bytes_per_depth", 0),
                "halo_ratio": fs.get("halo_ratio", 0.0),
                "shard_map_source": fs.get("shard_map_source", ""),
                "halo_exchange": fs.get("halo_exchange", ""),
                "queue_depth": queue_depth,
                "ingest_depth": ingest_depth,
                "total_ipt": self.total_ipt,
                "ipt_per_request": self.total_ipt / c,
                "ipt_p50": self.request_ipt.percentile(50),
                "ipt_p99": self.request_ipt.percentile(99),
                "latency_p50_s": self.latency.percentile(50),
                "latency_p99_s": self.latency.percentile(99),
                "latency_mean_s": self.latency.mean(),
                "invocations": self.invocations,
                "invocation_failures": self.invocation_failures,
                "invocation_stall_s": self.invocation_stall_s,
                "invocation_overlap_s": self.invocation_overlap_s,
                "completed_during_invocation":
                    self.completed_during_invocation,
                "partition_swaps": self.partition_swaps,
                # -- batched enumeration ---------------------------------------
                "enum_sweeps": self.enum_sweeps,
                "frontier_rows": self.frontier_rows,
                "enum_sweeps_per_batch":
                    self.enum_sweeps / max(self.batches, 1),
                "frontier_rows_per_batch":
                    self.frontier_rows / max(self.batches, 1),
                "workers_reporting": len(self.completed_by_worker),
                **by_worker,
                # -- health / degradation -------------------------------------
                # "healthy" means: no unrecovered worker or invocation error
                # and the loop is serving at its configured (base) backend
                # rung; a watchdog abort or failed run clears only when a
                # later invocation starts clean
                "healthy": int(not degraded and not worker_error
                               and not invocation_error),
                "degraded": int(bool(degraded)),
                "field_backend": field_backend,
                "worker_error": worker_error,
                "invocation_error": invocation_error,
                "watchdog_aborts": self.watchdog_aborts,
                "backend_fallbacks": self.backend_fallbacks,
                "backend_recoveries": self.backend_recoveries,
                "upload_failures": self.upload_failures,
                "snapshots_taken": self.snapshots_taken,
                "snapshot_failures": self.snapshot_failures,
                "replayed_mutations": self.replayed_mutations,
                "journal_seq": journal_seq,
                # -- replication health (zeros on unreplicated loops) ----------
                # epoch = the fencing token this node believes it holds;
                # cluster_epoch = the hub's current term.  A node with
                # epoch < cluster_epoch is a fenced zombie: fenced_writes
                # counts its rejected durable writes and last_stale_epoch
                # surfaces the stale token the fence saw last
                "epoch": epoch,
                "cluster_epoch": cluster_epoch,
                "fenced": int(0 < epoch < cluster_epoch),
                "fenced_writes": fenced_writes,
                "fencing_rejections": fencing_rejections,
                "last_stale_epoch": last_stale_epoch,
                "fence_error": fence_error,
                # monotonic durations (satellite: manifest wall-time fix) —
                # capture = copying host state, publish = background write
                "snapshot_capture_s": snapshot_capture_s,
                "snapshot_publish_s": snapshot_publish_s,
                **(extra or {}),
            }
