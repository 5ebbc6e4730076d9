"""Synchronous facade over the async serving subsystem.

The original seed-era ``GraphQueryEngine`` — a private synchronous loop
with its own L1-drift repartition trigger — is gone; this module re-derives
the same call-and-response API as a thin shell over
:class:`repro_torch.serve.loop.ServingLoop` driven inline (no threads): requests
are admitted through the bounded queue, served in micro-batches via the
batched executor, and repartitioning is decided by ``OnlinePolicy`` /
``OnlineTaper`` like every other consumer — the workload-drift trigger is
``OnlinePolicy.drift_l1`` and the first fit is the policy's explicit
``first_invocation_after`` bootstrap (replacing the old "huge counter"
sentinel).  Use :class:`~repro_torch.serve.loop.ServingLoop` directly for the
threaded, invocation-overlapped deployment mode — including multi-worker
serving (``ServeLoopConfig.n_workers``); the facade always drives inline
on the calling thread, so worker count does not apply here.

The field runs on ``device`` (default ``"cuda"``, raising without CUDA;
tests pass ``"cpu"``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.online import OnlinePolicy
from repro_torch.core.rpq import RPQ
from repro_torch.core.taper import TaperConfig
from repro_torch.device import DeviceLike
from repro_torch.graphs.graph import LabelledGraph, MutationBatch
from repro_torch.obs import Observability
from repro_torch.serve.loop import ServeLoopConfig, ServingLoop
from repro_torch.workload.sketch import FrequencySketch


@dataclass
class ServeConfig:
    max_results_per_query: int = 32
    sketch_half_life: float = 500.0
    drift_threshold: float = 0.25       # L1 distance between workloads
    min_requests_between_invocations: int = 500
    #: completed requests before the first (bootstrap) invocation may fire
    first_invocation_after: int = 0
    micro_batch: int = 32
    #: directory for durable snapshots + mutation WAL (None = crash safety
    #: off); passed straight through to ``ServeLoopConfig.snapshot_dir``
    snapshot_dir: Optional[str] = None
    #: request-trace sampling rate (0 = tracing off); forwarded to
    #: ``ServeLoopConfig.trace_sample_rate``.  For full control (shared
    #: registry, flight-recorder dump dir) pass ``obs`` instead.
    trace_sample_rate: float = 0.0
    #: pre-built observability bundle; overrides ``trace_sample_rate``
    obs: Optional["Observability"] = None
    taper: TaperConfig = field(default_factory=lambda: TaperConfig(max_iterations=4))


@dataclass
class RequestResult:
    query: str
    n_results: int
    ipt: int
    latency_s: float


class GraphQueryEngine:
    """Blocking serve_batch API over the async engine (inline pump)."""

    def __init__(self, g: LabelledGraph, part: np.ndarray, k: int,
                 config: Optional[ServeConfig] = None,
                 device: DeviceLike = None):
        self.cfg = config or ServeConfig()
        policy = OnlinePolicy(
            # the drift trigger is the only workload-driven one the old
            # engine had; cadence/topology/ipt stay off in the facade
            cadence=10 ** 9,
            min_interval=0,
            dirty_fraction=2.0,
            drift_l1=self.cfg.drift_threshold,
            bootstrap_after_ticks=0,
        )
        self.loop = ServingLoop(
            g, k,
            part=np.asarray(part, dtype=np.int32),
            taper_config=self.cfg.taper,
            policy=policy,
            sketch=FrequencySketch(half_life=self.cfg.sketch_half_life),
            config=ServeLoopConfig(
                micro_batch=self.cfg.micro_batch,
                max_results_per_query=self.cfg.max_results_per_query,
                min_requests_between_invocations=(
                    self.cfg.min_requests_between_invocations),
                first_invocation_after=self.cfg.first_invocation_after,
                overlap_invocations=False,  # inline drive: synchronous
                snapshot_dir=self.cfg.snapshot_dir,
                trace_sample_rate=self.cfg.trace_sample_rate,
                obs=self.cfg.obs,
            ),
            device=device,
        )
        self.g = g
        self.k = k

    # -- compatibility surface ------------------------------------------------
    @property
    def part(self) -> np.ndarray:
        return self.loop.part

    @property
    def executor(self):
        return self.loop.executor

    @property
    def sketch(self):
        return self.loop.ot.sketch

    @property
    def obs(self):
        return self.loop.obs

    @property
    def invocations(self) -> int:
        return self.loop.ot.invocations

    @property
    def total_requests(self) -> int:
        return self.loop.metrics.completed

    @property
    def total_ipt(self) -> float:
        return self.loop.metrics.total_ipt

    # -- serving -----------------------------------------------------------
    def serve_batch(self, queries: Sequence[RPQ]) -> List[RequestResult]:
        """Admit, execute and account one batch of requests, blocking until
        every result is materialised (invocations run inline)."""
        tickets = []
        for q in queries:
            admission = self.loop.submit(q)
            while not admission.accepted:
                # inline mode: we ARE the worker, so drain and retry rather
                # than bouncing the rejection to the caller
                self.loop.pump()
                admission = self.loop.submit(q)
            tickets.append(admission)
        while not all(t.done.is_set() for t in tickets):
            self.loop.pump()
        return [
            RequestResult(t.query.to_text(), len(t.paths), t.ipt, t.latency_s)
            for t in tickets
        ]

    def apply_mutations(self, batch: MutationBatch) -> None:
        """Queue a topology delta; applied before the next micro-batch."""
        self.loop.submit_mutations(batch)

    def snapshot(self) -> None:
        """Persist the full serving state now (requires ``snapshot_dir``)."""
        self.loop.snapshot(sync=True)

    # -- online maintenance --------------------------------------------------
    def workload_drift(self) -> float:
        return self.loop.ot.workload_drift()

    # -- metrics -------------------------------------------------------------
    def stats(self) -> Dict:
        s = self.loop.stats()
        s.update({
            "requests": s["completed"],
            "invocations": self.loop.ot.invocations,
            "drift": self.workload_drift(),
        })
        return s
