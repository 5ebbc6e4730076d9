"""Asynchronous graph-query serving loop with overlapped TAPER invocations.

The subsystem's control flow (the JAX package's ``serve/README.md`` has
the full architecture note):

* **request path** — clients :meth:`ServingLoop.submit` RPQ requests into a
  bounded :class:`~repro_torch.serve.queueing.RequestQueue`; executor workers
  drain them in micro-batches and execute each batch through
  ``QueryExecutor.enumerate_paths_many`` (batched frontier enumeration,
  shared per-query plans) against the *current* partition vector.  With
  ``n_workers > 1`` the N workers drain the shared queue concurrently:
  worker 0 (the primary) keeps the whole control plane and quiesces the
  secondaries only while it mutates (ingest patch, partition commit);
* **ingest path** — topology deltas enter a bounded
  :class:`~repro_torch.serve.ingest.IngestQueue`; the worker drains and coalesces
  them between invocations, applies them through
  ``LabelledGraph.apply_mutations`` (merge-patching every derived cache)
  and, under a sharded field backend (``cuda_sharded``/``torch_sharded``),
  immediately re-uploads this rank's dirty shard slices so device state
  stays warm before the next invocation;
* **invocation overlap** — every served micro-batch advances one
  ``OnlineTaper`` tick; when the policy fires, the invocation's inputs are
  snapshotted (``begin_invocation``) and the extroversion-field/swap run
  executes on a dedicated thread, on the loop's device, while the worker
  keeps serving against the **old** partition vector (double buffering).
  On completion the worker commits: one atomic rebind of the partition
  vector (readers see old or new, never a torn mix).  Ingest is deferred
  while a run is in flight — the graph must stay immutable under the field
  evaluation — which is exactly when the ingest queue's backpressure
  engages;
* **metrics** — per-request ipt and latency percentiles, queue depths and
  invocation stall/overlap accounting via
  :class:`~repro_torch.serve.metrics.ServeMetrics`, exported as plain dicts.

``overlap_invocations=False`` degrades the same loop to the stop-the-world
baseline (the invocation runs inline on the worker, serving stalls) — the
comparison ``benchmarks/serve_loop.py`` quantifies.

Crash safety & graceful degradation:

* **durability** — with ``snapshot_dir`` set, mutations are journaled on
  ingest *before* they apply: each drained coalesced group writes its
  members to the WAL, applies, then records the apply outcome
  (:class:`~repro_torch.serve.snapshot.MutationJournal`), and each committed
  invocation persists a full serving snapshot on a background thread
  (:class:`~repro_torch.serve.snapshot.ServingSnapshotter`).
  :meth:`ServingLoop.restore` = latest readable snapshot + WAL replay of
  the exact apply stream — bitwise parity with a node that never crashed;
* **watchdog** — an overlapped invocation exceeding
  ``invocation_timeout_s`` is cooperatively aborted (the run thread polls
  an abort flag at iteration boundaries) and abandoned; ingest and new
  invocations stay gated until the zombie thread actually exits (the
  enhancement ran against the live graph, which must stay immutable under
  it), while request serving continues on the old partition throughout;
* **backend ladder** — invocation failures feed a circuit breaker
  (``serve.control.Breaker``) whose trip — ``backend_fallback_after``
  failures in its window at the configured error rate, or that many
  consecutive failures (the historic strike count as the degenerate
  case) — walks ``field_backend`` one rung down ``FIELD_BACKEND_LADDER``
  (``cuda_sharded → cuda → torch``: lose scale, keep availability; the
  ``torch`` rung is the plain field on the loop's own device, on the card
  when the loop is on the card);
  after ``backend_probe_after`` healthy commits the loop probes one rung
  back up, doubling the dwell after each failed probe so a flapping
  device converges to its stable rung.  A hand-written kernel that fails
  to build or launch (:class:`~repro_torch.kernels.KernelError`) is no
  strike: the loop stops invoking, keeps serving, and raises the error
  from :meth:`ServingLoop.pump` and :meth:`ServingLoop.stop`;
* **fault injection** — a :class:`~repro_torch.serve.faults.FaultInjector`
  (``ServeLoopConfig.faults``) arms the loop's named fault sites
  (invocation body, shard upload, coalesced ingest group) so tests and
  a recovery benchmark can drive every degradation path on demand.

Device: the loop's :class:`~repro_torch.core.online.OnlineTaper` evaluates
its field on ``device`` (default ``"cuda"``, raising without CUDA; tests
pass ``"cpu"``).  ``TaperConfig.field_backend=None`` resolves to the rung
of that device when the loop is built (``cuda`` on a CUDA device,
``torch`` on the CPU), so the ladder always starts from a named rung.

Sharded serving: under ``cuda_sharded``/``torch_sharded`` every rank of the
field's process group (``launch/mesh.py``) drives the same loop over the
same request and mutation stream (SPMD), and every rank runs each
invocation in full.  That holds only under inline drive
(``overlap_invocations=False`` and :meth:`ServingLoop.pump`), where the
stream alone decides every step; threaded sharded serving across ranks,
where the ranks' invocation boundaries would have to be agreed, comes with
the cluster slice.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, replace as dc_replace
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np

from repro_torch.core.online import OnlinePolicy, OnlineTaper, PendingInvocation
from repro_torch.core.rpq import RPQ
from repro_torch.core.taper import FIELD_BACKEND_LADDER, InvocationAborted, TaperConfig
from repro_torch.core.visitor import SHARDED_BACKENDS
from repro_torch.device import DeviceLike
from repro_torch.graphs.graph import LabelledGraph, MutationBatch
from repro_torch.kernels import KernelError
from repro_torch.serve.faults import (
    FaultInjector,
    InjectedFault,
    SITE_INGEST_GROUP,
    SITE_INVOCATION,
    SITE_SHARD_UPLOAD,
)
from repro_torch.obs import Observability
from repro_torch.obs.registry import Registry
from repro_torch.obs.trace import NOOP_SPAN, NOOP_TRACE
from repro_torch.serve.control import (
    Breaker,
    BrownoutController,
    ControlConfig,
    serve_pressure,
)
from repro_torch.serve.ingest import IngestQueue
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.queueing import Rejection, RequestQueue, ServeTicket
from repro_torch.serve.replication import FencedWrite, commit_payload
from repro_torch.serve.snapshot import (
    MutationJournal,
    RestoreResult,
    ServingSnapshotter,
    WAL_NAME,
    capture_serving_state,
    restore_serving_state,
)
from repro_torch.utils import get_logger
from repro_torch.workload.executor import QueryExecutor

log = get_logger("serve.loop")


@dataclass
class ServeLoopConfig:
    micro_batch: int = 16
    max_queue_depth: int = 256
    max_ingest_depth: int = 64
    max_results_per_query: int = 32
    #: run TAPER invocations on a dedicated thread, overlapped with serving
    #: (False = stop-the-world: the worker blocks for the whole invocation)
    overlap_invocations: bool = True
    #: minimum completed requests between consecutive invocations
    min_requests_between_invocations: int = 0
    #: completed requests before the first (bootstrap) invocation may fire
    first_invocation_after: int = 0
    #: how long an idle worker waits for requests before re-polling
    batch_wait_s: float = 0.005
    metrics_window: int = 2048
    #: executor worker threads draining the request queue.  Worker 0 (the
    #: primary) owns the whole control plane — ingest, invocation trigger
    #: and commit, snapshots; workers 1.. only take_batch + serve.  Serving
    #: reads are lock-free (one atomic ``ot.part`` read per micro-batch);
    #: mutations quiesce the secondaries only for the pointer swap / patch
    n_workers: int = 1
    # -- durability (None = crash safety off) ---------------------------------
    #: directory for snapshots + the mutation WAL
    snapshot_dir: Optional[str] = None
    #: persist a snapshot (async, off the worker) after every committed
    #: invocation — the commit already repacked device state, and the WAL
    #: window stays invocation-free, which is what recovery parity leans on
    snapshot_on_commit: bool = True
    #: additionally snapshot at this wall-clock period while quiescent
    snapshot_every_s: Optional[float] = None
    snapshot_keep: int = 3
    #: fsync the WAL on every append (power-loss durability; slower)
    wal_sync: bool = False
    # -- graceful degradation -------------------------------------------------
    #: abort an overlapped invocation running longer than this (None = off)
    invocation_timeout_s: Optional[float] = None
    #: base retry backoff after a failed invocation (doubles per
    #: consecutive failure)
    invocation_retry_backoff_s: float = 0.05
    #: consecutive invocation failures before falling one rung down the
    #: field-backend ladder
    backend_fallback_after: int = 2
    #: healthy commits at a degraded rung before probing back up
    backend_probe_after: int = 8
    #: fault-injection registry (tests / recovery benchmark)
    faults: Optional[FaultInjector] = None
    #: how long stop() waits for the workers, an in-flight or abandoned
    #: invocation and the snapshot writer; past it the run is told to
    #: abort and stop() raises TimeoutError
    stop_timeout_s: float = 300.0
    # -- observability --------------------------------------------------------
    #: shared tracing/flight-recorder/registry bundle; None builds one from
    #: ``trace_sample_rate`` (or the shared disabled bundle at rate 0, the
    #: default — the hot path then pays a single attribute check)
    obs: Optional[Observability] = None
    #: request-trace sampling rate used when ``obs`` is not given
    #: (1.0 = every request, 0.0 = observability off)
    trace_sample_rate: float = 0.0
    # -- control loops --------------------------------------------------------
    #: closed-loop overload protection (``serve.control``): brownout
    #: admission over live per-class latency quantiles, pressure-aware
    #: invocation cadence, and rate-based backend-breaker tuning.  None
    #: (the default) keeps the static thresholds — no control loops run,
    #: though the backend ladder still trips through a :class:`Breaker`
    #: whose parameters degenerate to the historic strike count.
    control: Optional[ControlConfig] = None


class ServingLoop:
    """Micro-batched serving engine over one mutable graph (module doc)."""

    def __init__(
        self,
        g: Optional[LabelledGraph] = None,
        k: Optional[int] = None,
        part: Optional[np.ndarray] = None,
        taper_config: Optional[TaperConfig] = None,
        policy: Optional[OnlinePolicy] = None,
        config: Optional[ServeLoopConfig] = None,
        sketch=None,
        ot: Optional[OnlineTaper] = None,
        device: DeviceLike = None,
    ):
        self.cfg = config or ServeLoopConfig()
        if ot is not None:
            # restore path: adopt a fully reconstructed OnlineTaper verbatim
            self.ot = ot
        else:
            if g is None or k is None:
                raise ValueError("g and k are required unless ot= is given")
            if policy is None:
                # serving loops bootstrap their first fit from live traffic
                policy = OnlinePolicy(bootstrap_after_ticks=0)
            self.ot = OnlineTaper(
                g, k, part=part, config=taper_config, policy=policy,
                sketch=sketch, device=device)
        self.g = self.ot.g
        self.k = self.ot.k
        g = self.g
        self.executor = QueryExecutor(g)
        # admission classes: the queue grades backpressure by per-query
        # sketch frequency (hot queries have warm plans/DP rows); the
        # frequency snapshot refreshes once per served micro-batch
        self._adm_freqs: Dict[str, float] = {}
        self.requests = RequestQueue(
            self.cfg.max_queue_depth,
            admission_weight=lambda q: self._adm_freqs.get(q.qhash, 0.0))
        self.ingest = IngestQueue(self.cfg.max_ingest_depth)
        self.metrics = ServeMetrics(self.cfg.metrics_window)
        self._pending: Optional[PendingInvocation] = None
        self._inflight: Optional[threading.Thread] = None
        self._invocation_done = threading.Event()
        self._invocation_t0 = 0.0
        self._invocation_error: Optional[BaseException] = None
        #: a kernel that failed to build or launch: no ladder strike; no
        #: invocation starts again, and pump() and stop() raise it
        self._kernel_error: Optional[KernelError] = None
        self._worker_error: Optional[BaseException] = None
        self._requests_since_invocation = 0
        self._ipt_ewma: Optional[float] = None
        self._stop = threading.Event()
        self._worker: Optional[threading.Thread] = None
        # -- multi-worker serving ----------------------------------------------
        #: secondary executor threads (worker ids 1..n_workers-1)
        self._secondaries: List[threading.Thread] = []
        #: quiesce gate: secondaries serve inside _serving_section();
        #: mutators (primary only) close the gate and wait out in-flight
        #: batches before touching graph arrays or committing a partition
        self._gate = threading.Condition()
        self._gate_open = True
        self._active_serves = 0
        #: serialises the request-side observation state shared by all
        #: workers: the frequency sketch, admission freqs, the ipt EWMA and
        #: the invocation trigger counters (none of which are thread-safe)
        self._observe_lock = threading.Lock()
        # -- crash safety ------------------------------------------------------
        self._faults = self.cfg.faults
        self._journal: Optional[MutationJournal] = None
        self._snapshotter: Optional[ServingSnapshotter] = None
        #: WAL seq of the last coalesced group whose effect — applied or
        #: validation-dropped — is in the live state; snapshots record it
        #: so restore replays exactly the tail
        self._applied_seq = 0
        self._last_snapshot_t = time.monotonic()
        if self.cfg.snapshot_dir is not None:
            snap_dir = Path(self.cfg.snapshot_dir)
            self._journal = MutationJournal(snap_dir / WAL_NAME,
                                            sync=self.cfg.wal_sync)
            self._snapshotter = ServingSnapshotter(
                snap_dir, keep=self.cfg.snapshot_keep, journal=self._journal)
        # -- graceful degradation ---------------------------------------------
        taper_cfg = self.ot.taper.config
        if taper_cfg.field_backend is None:
            # the ladder walks named rungs: None becomes its device's rung
            taper_cfg.field_backend = (
                "cuda" if self.ot.taper.device.type == "cuda" else "torch")
        #: the configured rung; anything below it counts as degraded
        self._base_backend = taper_cfg.field_backend
        self._consec_invocation_failures = 0
        self._backoff_until = 0.0
        self._healthy_since_fallback = 0
        self._probe_after = self.cfg.backend_probe_after
        #: per-run cooperative-cancel flag (fresh Event per overlapped run)
        self._abort_flag = threading.Event()
        #: watchdog-abandoned invocation threads still winding down; ingest
        #: and new invocations are gated until they exit (the run reads the
        #: live graph, which must stay immutable under it)
        self._abandoned: List[threading.Thread] = []
        #: set by restore(); None on a fresh loop
        self.restore_result: Optional[RestoreResult] = None
        # -- replication (None = single-node, zero behaviour change) -----------
        #: cluster hub this loop publishes to as primary (attach_replication)
        self._replication = None
        #: the epoch this loop believes it holds the write lease for; a
        #: deposed primary keeps its stale epoch and gets fenced
        self._epoch = 1
        self._fenced_writes = 0
        self._fence_error: Optional[BaseException] = None
        # -- observability -----------------------------------------------------
        if self.cfg.obs is not None:
            self.obs = self.cfg.obs
        elif self.cfg.trace_sample_rate > 0:
            self.obs = Observability(
                trace_sample_rate=self.cfg.trace_sample_rate)
        else:
            self.obs = Observability.disabled()
        self._obs_on = self.obs.enabled
        #: the in-flight (or just-committed) invocation's trace context;
        #: the coordinator also plants a failover trace here so the forced
        #: epoch-opening commit frame carries it across nodes
        self._invocation_ctx = NOOP_TRACE
        self._invocation_span = NOOP_SPAN
        if self._obs_on:
            # queue + fault injector only pay tracing costs when wired
            self.requests.tracer = self.obs.tracer
            self.requests.recorder = self.obs.recorder
            if self._faults is not None and self._faults.recorder is None:
                self._faults.recorder = self.obs.recorder
            self.ot.taper.tracer = self.obs.tracer
            # replace-on-reregister: a promoted loop takes over the dead
            # primary's collector slots on the shared registry
            self.obs.registry.register_collector("serve", self.collect)
            self.obs.registry.register_collector(
                "executor", self.executor.collect)
        # -- control loops -----------------------------------------------------
        ctl = self.cfg.control
        clock = ctl.resolved_clock() if ctl is not None else time.monotonic
        #: the backend ladder's trip decision: error-rate-over-window with
        #: a consecutive-failure tail clause, so the historic
        #: ``backend_fallback_after`` strike count is the degenerate case
        self._backend_breaker = Breaker(
            "backend_ladder",
            window=max(ctl.breaker_window if ctl is not None else 16,
                       2 * self.cfg.backend_fallback_after),
            min_failures=self.cfg.backend_fallback_after,
            error_rate=(ctl.breaker_error_rate if ctl is not None else 0.5),
            recorder=(self.obs.recorder if self._obs_on else None),
            clock=clock)
        self._brownout: Optional[BrownoutController] = None
        self._ctl_registry: Optional[Registry] = None
        #: per-class request-latency histograms the brownout controller
        #: reads (lazily bound; only populated when control is configured)
        self._lat_hists: Dict[str, object] = {}
        #: EWMA of committed invocation wall time — the pressure signal's
        #: "traced invocation latency" input
        self._inv_wall_ewma = 0.0
        if ctl is not None:
            # brownout needs real histograms even when tracing is off; the
            # shared disabled bundle's registry must never be written to,
            # so an un-observed loop gets a private one
            self._ctl_registry = (self.obs.registry if self._obs_on
                                  else Registry())
            self._brownout = BrownoutController(
                self.requests, self._ctl_registry, ctl,
                recorder=(self.obs.recorder if self._obs_on else None))

    def collect(self) -> Dict[str, float]:
        """Metrics-registry collector: the loop's full SLO snapshot (the
        registry keeps numeric values and drops the string fields)."""
        return self.stats()

    def _inv_span(self, name: str, **attrs):
        """Span under the current invocation trace (no-op when unsampled)."""
        if not self._invocation_ctx.sampled:
            return NOOP_SPAN
        return self.obs.tracer.start(name, self._invocation_ctx, **attrs)

    def _clear_invocation_trace(self) -> None:
        self._invocation_ctx = NOOP_TRACE
        self._invocation_span = NOOP_SPAN
        self.ot.taper.trace_ctx = None

    # -- client API -----------------------------------------------------------
    @property
    def part(self) -> np.ndarray:
        """The live partition vector (atomically rebound on commit)."""
        return self.ot.part

    def submit(self, query: RPQ,
               cls: str = "hot") -> Union[ServeTicket, Rejection]:
        """Admit one request (any thread); see ``RequestQueue.submit``.
        ``cls`` is the request's SLO class (brownout shedding + per-class
        latency budgets when control loops are configured)."""
        return self.requests.submit(query, cls=cls)

    def submit_mutations(self, batch: MutationBatch) -> Union[bool, Rejection]:
        """Queue one topology delta (any thread); applied by the worker
        between invocations.  With durability on, the batch is journaled at
        the ingest drain, *before* it applies — the durability boundary is
        the next pump round's drain, not admission; producers needing a
        hard guarantee watch ``stats()["journal_seq"]`` advance."""
        return self.ingest.submit(batch)

    @property
    def degraded(self) -> bool:
        """True while serving below the configured field-backend rung."""
        return self.ot.taper.config.field_backend != self._base_backend

    # -- replication (primary side) -------------------------------------------
    def attach_replication(self, hub, epoch: Optional[int] = None) -> None:
        """Wire this loop up as the cluster primary.  Every durable write —
        journaling an ingest group, committing an invocation, publishing a
        snapshot — is first authorized against the hub's epoch fence (a
        :class:`~repro_torch.serve.replication.FencedWrite` drops the write and
        is counted, never propagated into the serving path) and, once
        through, shipped to the followers (group/commit frames); each pump
        round heartbeats.  Unattached loops are bit-for-bit the single-node
        loop."""
        self._replication = hub
        self._epoch = int(epoch if epoch is not None else hub.current_epoch)
        if hub.journal is None and self._journal is not None:
            hub.journal = self._journal

    def observe_served(self, queries, ipts, latencies=None,
                       allow_trigger: bool = True) -> None:
        """Fold reads served *off-loop* (the cluster router answers most
        reads directly on follower replicas) into this loop's observation
        state — sketch, admission frequencies, ipt EWMA, tick/trigger
        counters — so TAPER invocations still see the whole cluster's
        query workload, not just the primary's slice."""
        if not queries:
            return
        if latencies is not None:
            self.metrics.record_batch(
                latencies, ipts,
                overlapped=(self._inflight is not None
                            and not self._invocation_done.is_set()))
        with self._observe_lock:
            self.ot.observe(queries)
            self._adm_freqs = self.ot.sketch.frequencies(
                self.ot.policy.min_freq)
            self._requests_since_invocation += len(queries)
            mean_ipt = float(np.mean(ipts)) if len(ipts) else 0.0
            self._ipt_ewma = (mean_ipt if self._ipt_ewma is None
                              else 0.8 * self._ipt_ewma + 0.2 * mean_ipt)
        if allow_trigger:
            self._maybe_trigger()

    def _note_fenced(self, exc: FencedWrite) -> None:
        self._fenced_writes += 1
        self._fence_error = exc
        self.obs.recorder.record("fence_rejection", epoch=self._epoch,
                                 error=repr(exc))
        log.warning("fenced write rejected: %s", exc)

    def _fenced_commit_guard(self) -> bool:
        """True when a durable commit may proceed (no replication attached,
        or the epoch fence authorized it)."""
        if self._replication is None:
            return True
        try:
            self._replication.authorize(self._epoch, "invocation commit")
            return True
        except FencedWrite as exc:
            self._note_fenced(exc)
            return False

    def _publish_commit(self, force: bool = False) -> None:
        """Ship the just-committed invocation's volatile state (partition
        vector, RNG, placement prior, counters) to the followers."""
        if self._replication is None:
            return
        payload = commit_payload(self.ot)
        if self._invocation_ctx.sampled:
            # piggyback the invocation (or failover) trace id on the frame
            # so the followers' applies join the originating trace
            payload["trace_id"] = self._invocation_ctx.trace_id
        try:
            self._replication.publish_commit(
                self._epoch, payload, self._applied_seq, force=force)
        except FencedWrite as exc:
            self._note_fenced(exc)

    def stats(self) -> Dict[str, float]:
        rep: Dict[str, object] = {}
        if self._replication is not None:
            hub = self._replication.stats()
            rep = dict(
                epoch=self._epoch,
                cluster_epoch=hub["epoch"],
                fenced_writes=self._fenced_writes,
                fencing_rejections=(hub["fencing_rejections"]
                                    + hub["partition_rejections"]),
                last_stale_epoch=hub["last_stale_epoch"],
                fence_error=("" if self._fence_error is None
                             else repr(self._fence_error)),
            )
        if self._snapshotter is not None:
            rep["snapshot_capture_s"] = self._snapshotter.last_capture_s
            rep["snapshot_publish_s"] = self._snapshotter.last_wall_s
        extra: Dict[str, object] = {}
        if self.cfg.control is not None:
            extra = {
                "shed_level": self.requests.shed_level,
                "rejected_brownout": self.requests.rejected_brownout,
                "serve_pressure": self._serve_pressure(),
                "pressure_deferrals": self.ot.pressure_deferrals,
                "backend_breaker_state": self._backend_breaker.state,
                "backend_breaker_trips": self._backend_breaker.trips,
            }
        return self.metrics.snapshot(
            extra=extra,
            queue_depth=self.requests.depth(),
            ingest_depth=self.ingest.depth(),
            rejected_requests=self.requests.rejected,
            rejected_cold_requests=self.requests.rejected_cold,
            rejected_mutations=self.ingest.rejected,
            failed_mutations=self.ingest.failed,
            field_stats=self.ot.taper._pre.get("_halo_stats"),
            field_backend=self.ot.taper.config.field_backend,
            degraded=self.degraded,
            worker_error=("" if self._worker_error is None
                          else repr(self._worker_error)),
            invocation_error=("" if self._invocation_error is None
                              else repr(self._invocation_error)),
            journal_seq=self._applied_seq,
            **rep,
        )

    @property
    def invocation_in_flight(self) -> bool:
        return self._pending is not None

    # -- durability -----------------------------------------------------------
    def snapshot(self, sync: bool = True) -> None:
        """Capture and persist the full serving state now.  Call from the
        worker thread (a pump round) or while the loop is stopped — the
        capture copies host state; with ``sync=False`` the write itself
        happens on the snapshotter's background thread."""
        if self._snapshotter is None:
            raise RuntimeError("snapshot_dir not configured")
        if self._replication is not None:
            # a zombie primary must not publish snapshots: a follower
            # bootstrapping from one would adopt state the cluster has
            # moved past under a newer epoch
            try:
                self._replication.authorize(self._epoch, "snapshot publish")
            except FencedWrite as exc:
                self._note_fenced(exc)
                self.metrics.record_snapshot(False)
                return
        try:
            with self._observe_lock:
                # the capture copies the sketch, which secondary workers
                # are concurrently observing into
                state = capture_serving_state(self.ot, self._applied_seq)
            self._snapshotter.save(state, sync=sync)
            self.metrics.record_snapshot(True)
            self._last_snapshot_t = time.monotonic()
        except BaseException:
            self.metrics.record_snapshot(False)
            log.exception("serving snapshot failed; continuing without")

    @classmethod
    def restore(
        cls,
        directory,
        taper_config: Optional[TaperConfig] = None,
        policy: Optional[OnlinePolicy] = None,
        config: Optional[ServeLoopConfig] = None,
        n_shards: Optional[int] = None,
        snap_id: Optional[int] = None,
        device: DeviceLike = None,
    ) -> "ServingLoop":
        """Bring a crashed node back: latest readable snapshot under
        ``directory`` + WAL replay, then a loop serving that state.  Pass
        ``n_shards`` to restore onto a different shard count (elastic
        restore; the k→S shard fold is recomputed and
        ``restore_result.elastic_plan`` carries the byte-movement budget).
        The restored loop keeps journaling/snapshotting into the same
        directory and starts at the *configured* backend rung — a restart
        is the natural probe that a device fault has cleared."""
        cfg = config or ServeLoopConfig()
        if policy is None:
            policy = OnlinePolicy(bootstrap_after_ticks=0)
        if cfg.snapshot_dir is None:
            cfg = dc_replace(cfg, snapshot_dir=str(directory))
        res = restore_serving_state(
            directory, taper_config=taper_config, policy=policy,
            n_shards=n_shards, snap_id=snap_id, device=device)
        loop = cls(config=cfg, ot=res.ot)
        loop._applied_seq = res.journal_seq
        loop.metrics.replayed_mutations = res.replayed
        loop.restore_result = res
        if loop.ot.taper.config.field_backend in SHARDED_BACKENDS:
            # re-derive device-resident packings eagerly so the first
            # invocation after restart starts warm, like a running node's
            loop._warm_devices()
        return loop

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "ServingLoop":
        """Spawn the worker thread (threaded mode).  Alternatively drive the
        loop inline — no threads — by calling :meth:`pump` directly."""
        if self._worker is not None:
            raise RuntimeError("serving loop already started")
        self._stop.clear()
        self._worker = threading.Thread(
            target=self._run, name="serve-worker", daemon=True)
        self._worker.start()
        for wid in range(1, max(1, self.cfg.n_workers)):
            t = threading.Thread(
                target=self._serve_run, args=(wid,),
                name=f"serve-worker-{wid}", daemon=True)
            t.start()
            self._secondaries.append(t)
        return self

    def stop(self, drain: bool = True) -> Dict[str, float]:
        """Stop the worker; optionally drain queued requests/ingest first.
        Returns a final metrics snapshot.  Raises only when the *latest*
        invocation failed (earlier transient failures are counted in
        ``invocation_failures`` and logged when they happen, so a recovered
        blip does not surface as a stale exception hours later), or a
        kernel failed.  Every join waits at most ``stop_timeout_s`` in all;
        past it the in-flight run is told to abort and ``TimeoutError``
        is raised."""
        deadline = time.monotonic() + self.cfg.stop_timeout_s
        self._stop.set()
        for t in self._secondaries:
            self._join(t, deadline, "a serve worker")
        self._secondaries = []
        if self._worker is not None:
            self._join(self._worker, deadline, "the serve worker")
            self._worker = None
        self._finish_inflight(deadline)
        if drain:
            while self._pump_once(wait_s=0.0, allow_trigger=False):
                pass
            if not self._zombies_active():
                self._apply_ingest()
        if self._snapshotter is not None:
            self._snapshotter.close(
                timeout=max(0.0, deadline - time.monotonic()))
        if self._journal is not None:
            self._journal.close()
        if self._kernel_error is not None:
            raise self._kernel_error
        if self._worker_error is not None:
            raise self._worker_error
        if self._invocation_error is not None:
            raise self._invocation_error
        return self.stats()

    def _serve_run(self, wid: int) -> None:
        """Secondary executor worker: take_batch + serve, nothing else.
        The control plane (ingest, invocations, snapshots) stays on the
        primary; a mutation there closes the gate, so a secondary is either
        idle, blocked at the gate, or serving against a stable graph."""
        while not self._stop.is_set():
            try:
                batch = self.requests.take_batch(
                    self.cfg.micro_batch, timeout=self.cfg.batch_wait_s)
                if not batch:
                    continue
                with self._serving_section():
                    self._serve_batch(batch, worker_id=wid)
                self._worker_error = None
            except BaseException as exc:
                self._worker_error = exc
                log.exception("serve worker %d round failed", wid)
                time.sleep(self.cfg.batch_wait_s)

    @contextmanager
    def _serving_section(self):
        """Secondary workers serve inside this: blocks while the gate is
        closed (a mutation in progress), counts the batch as in-flight so
        :meth:`_quiesced` can wait it out.  The gate always reopens —
        ``_quiesced`` restores it in a ``finally`` — so this never hangs."""
        with self._gate:
            while not self._gate_open:
                self._gate.wait(0.1)
            self._active_serves += 1
        try:
            yield
        finally:
            with self._gate:
                self._active_serves -= 1
                self._gate.notify_all()

    @contextmanager
    def _quiesced(self):
        """Primary-only: close the serving gate and wait for in-flight
        secondary batches to finish, hold it closed for the body (a graph
        patch or a partition commit), reopen on exit.  No-op while no
        secondaries are live (single-worker loops, inline pump, post-join
        drain) — the primary's own serving is naturally serialised."""
        if not any(t.is_alive() for t in self._secondaries):
            yield
            return
        with self._gate:
            self._gate_open = False
            while self._active_serves:
                self._gate.wait(0.1)
        try:
            yield
        finally:
            with self._gate:
                self._gate_open = True
                self._gate.notify_all()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self._pump_once(wait_s=self.cfg.batch_wait_s,
                                allow_trigger=True)
                self._worker_error = None   # healthy round: blip recovered
            except BaseException as exc:
                # a dead worker would silently wedge every outstanding
                # ticket; log, remember for stop() (cleared again by the
                # next healthy round, so only a *current* fault surfaces
                # there), and keep serving — the backoff stops a
                # persistent fault from spinning hot
                self._worker_error = exc
                log.exception("serve worker round failed")
                time.sleep(self.cfg.batch_wait_s)

    # -- one scheduling round -------------------------------------------------
    def pump(self, wait_s: float = 0.0) -> int:
        """Inline drive: one scheduling round on the calling thread.
        Returns the number of requests served this round; raises the
        :class:`~repro_torch.kernels.KernelError` of a failed kernel after
        the round."""
        served = self._pump_once(wait_s=wait_s, allow_trigger=True)
        if self._kernel_error is not None:
            raise self._kernel_error
        return served

    def _pump_once(self, wait_s: float, allow_trigger: bool) -> int:
        if self._replication is not None:
            # liveness beacon; silently lost from a stale epoch or across a
            # partition, which is what starts the coordinator's failover clock
            self._replication.heartbeat(self._epoch, self._applied_seq,
                                        int(self.g.version))
        self._commit_if_done()
        if self._pending is None and not self._zombies_active():
            self._apply_ingest()
        batch = self.requests.take_batch(self.cfg.micro_batch, timeout=wait_s)
        if batch:
            self._serve_batch(batch)
            if allow_trigger:
                self._maybe_trigger()
        if self._brownout is not None:
            # one controller window per elapsed window_s: reads the live
            # per-class latency quantiles, moves the queue's shed level
            self._brownout.maybe_tick()
        self._commit_if_done()
        if (self._snapshotter is not None
                and self.cfg.snapshot_every_s is not None
                and self._pending is None
                and not self._zombies_active()
                and time.monotonic() - self._last_snapshot_t
                >= self.cfg.snapshot_every_s):
            self.snapshot(sync=False)
        return len(batch)

    def _serve_batch(self, batch: List[ServeTicket],
                     worker_id: int = 0) -> None:
        overlapped = (self._inflight is not None
                      and not self._invocation_done.is_set())
        queries = [t.query for t in batch]
        part = self.ot.part  # one read: stable for the whole micro-batch
        batch_span = NOOP_SPAN
        if self._obs_on:
            # one drain→enumerate→reply span per micro-batch, joined to the
            # first sampled ticket's trace (a per-ticket span here would tax
            # the hot path ~2x; every sampled request still closes its own
            # admission-opened "request" span with the serve outcome)
            for t in batch:
                if t.trace.sampled:
                    batch_span = self.obs.tracer.start(
                        "request.batch", t.trace, worker_id=worker_id,
                        batch_size=len(batch),
                        queue_wait_s=(time.perf_counter() - t.submitted_s))
                    break
        t0 = time.perf_counter()
        enum_stats: Dict[str, int] = {}
        results = self.executor.enumerate_paths_many(
            queries, max_results=self.cfg.max_results_per_query, part=part,
            stats=enum_stats)
        dt = time.perf_counter() - t0
        batch_span.end(enum_sweeps=enum_stats.get("enum_sweeps", 0),
                       frontier_rows=enum_stats.get("frontier_rows", 0))
        for ticket, (paths, crossings) in zip(batch, results):
            ticket.complete(paths, crossings)
        if self._ctl_registry is not None:
            # per-class latency histograms: what the brownout controller's
            # windowed quantile estimator reads each controller window
            for t in batch:
                h = self._lat_hists.get(t.cls)
                if h is None:
                    h = self._lat_hists[t.cls] = self._ctl_registry.histogram(
                        "request_latency_s", cls=t.cls)
                h.observe(t.latency_s)
        self.requests.record_service_time(dt / len(batch))
        self.metrics.record_batch(
            [t.latency_s for t in batch], [t.ipt for t in batch], overlapped,
            enum_sweeps=enum_stats.get("enum_sweeps", 0),
            frontier_rows=enum_stats.get("frontier_rows", 0),
            worker_id=worker_id)
        with self._observe_lock:
            self.ot.observe(queries)
            # one snapshot per batch (O(#distinct queries)); admission reads
            # it lock-free via atomic rebind
            self._adm_freqs = self.ot.sketch.frequencies(
                self.ot.policy.min_freq)
            self._requests_since_invocation += len(batch)
            mean_ipt = float(np.mean([t.ipt for t in batch]))
            self._ipt_ewma = (mean_ipt if self._ipt_ewma is None
                              else 0.8 * self._ipt_ewma + 0.2 * mean_ipt)

    # -- invocation scheduling ------------------------------------------------
    def _serve_pressure(self) -> float:
        """The loop's [0, 1] overload signal (``serve.control``): queue
        fullness + brownout shed depth + invocation wall cost relative to
        the watchdog budget."""
        ctl = self.cfg.control
        depth_frac = self.requests.depth() / max(self.requests.max_depth, 1)
        shed_frac = (self.requests.shed_level
                     / max(self.requests.max_shed_level, 1))
        inv_frac = 0.0
        if self.cfg.invocation_timeout_s:
            inv_frac = min(
                1.0, self._inv_wall_ewma / self.cfg.invocation_timeout_s)
        return serve_pressure(depth_frac, shed_frac, inv_frac, ctl)

    def _maybe_trigger(self) -> None:
        pressure = (self._serve_pressure()
                    if self.cfg.control is not None else None)
        with self._observe_lock:
            # one tick per micro-batch; the sketch is concurrently written
            # by secondary workers' observe()
            reason = self.ot.poll(self._ipt_ewma, pressure=pressure)
        if reason is None or self._pending is not None:
            return
        if self._kernel_error is not None:
            return  # a failed kernel is raised, never retried or ladder-walked
        if self._zombies_active():
            # an abandoned run is still reading the graph; starting another
            # enhancement (or mutating) under it is not safe — keep serving
            return
        if time.monotonic() < self._backoff_until:
            return  # abort-and-retry backoff after a failed invocation
        if self.ot.invocations == 0:
            if self.metrics.completed < self.cfg.first_invocation_after:
                return
        elif (self._requests_since_invocation
                < self.cfg.min_requests_between_invocations):
            return
        inv_root = NOOP_SPAN
        if self._obs_on:
            # invocations are rare and load-bearing: always sampled
            ctx = self.obs.tracer.new_trace(force=True)
            inv_root = self.obs.tracer.start(
                "invocation", ctx, reason=str(reason),
                overlapped=self.cfg.overlap_invocations, epoch=self._epoch)
            self._invocation_ctx = inv_root.context()
            self._invocation_span = inv_root
            # field/swap/redeal spans inside Taper join this trace
            self.ot.taper.trace_ctx = self._invocation_ctx
        with self._inv_span("invocation.snapshot"):
            with self._observe_lock:
                # the invocation snapshot reads the sketch/workload state
                pending = self.ot.begin_invocation(reason)
        if pending is None:
            inv_root.end(skipped=True)
            self._clear_invocation_trace()
            return
        self._pending = pending
        if self.cfg.overlap_invocations:
            self._invocation_done = threading.Event()
            self._abort_flag = threading.Event()
            self._invocation_error = None   # only the latest run's outcome
            self._invocation_t0 = time.perf_counter()
            self._inflight = threading.Thread(
                target=self._invocation_main,
                args=(pending, self._abort_flag, self._invocation_done),
                name="serve-invocation", daemon=True)
            self._inflight.start()
        else:
            t0 = time.perf_counter()
            try:
                if self._faults is not None:
                    self._faults.fire(SITE_INVOCATION)
                self.ot.run_invocation(pending)
            except KernelError as exc:
                self._kernel_error = self._invocation_error = exc
                self.metrics.record_invocation_failure()
                inv_root.end(error=repr(exc))
                self._clear_invocation_trace()
                raise
            except BaseException as exc:
                self.metrics.record_invocation_failure()
                self._note_invocation_failure()
                inv_root.end(error=repr(exc))
                self._clear_invocation_trace()
                raise
            finally:
                # a failed run must not leave the loop looking mid-flight
                # (that would disable ingest and all future invocations);
                # the exception still propagates — to the inline caller, or
                # to _run's guard in threaded mode
                self._pending = None
            wall = time.perf_counter() - t0
            if not self._fenced_commit_guard():
                # deposed primary: the enhancement ran but its result may
                # not become durable or visible — drop it on the floor
                self._requests_since_invocation = 0
                inv_root.end(fenced=True)
                self._clear_invocation_trace()
                return
            with self._inv_span("invocation.commit"):
                with self._quiesced():
                    self.ot.commit_invocation(pending)
            self.metrics.record_invocation(wall, overlapped=False)
            self._inv_wall_ewma = 0.7 * self._inv_wall_ewma + 0.3 * wall
            self._requests_since_invocation = 0
            self._note_invocation_success()
            self._warm_devices()
            self._publish_commit()
            inv_root.end(committed=True, wall_s=wall)
            self._clear_invocation_trace()
            if self._snapshotter is not None and self.cfg.snapshot_on_commit:
                self.snapshot(sync=False)

    def _invocation_main(self, pending: PendingInvocation,
                         abort: threading.Event,
                         done: threading.Event) -> None:
        try:
            if self._faults is not None:
                self._faults.fire(SITE_INVOCATION)
            if abort.is_set():
                raise InvocationAborted("aborted before start")
            self.ot.run_invocation(pending, should_abort=abort.is_set)
        except InvocationAborted:
            # the watchdog already did the bookkeeping when it abandoned us;
            # exiting promptly is this thread's whole job now
            log.info("abandoned invocation run exited cooperatively")
        except KernelError as exc:
            # no ladder strike: the loop stops invoking, pump()/stop() raise
            self._kernel_error = self._invocation_error = exc
            self.metrics.record_invocation_failure()
            log.exception("overlapped TAPER invocation: a kernel failed")
        except BaseException as exc:  # surfaced by stop() if still latest
            if not abort.is_set():
                self._invocation_error = exc
                self.metrics.record_invocation_failure()
                log.exception("overlapped TAPER invocation failed")
        finally:
            done.set()

    def _commit_if_done(self) -> None:
        if self._inflight is None:
            return
        if not self._invocation_done.is_set():
            self._check_watchdog()
            return
        self._inflight.join()
        wall = time.perf_counter() - self._invocation_t0
        committed = False
        fenced = False
        if self._pending is not None and self._pending.report is not None:
            if self._fenced_commit_guard():
                # quiesce only for the pointer swap: secondaries finish
                # their in-flight batch, the commit rebinds ot.part (plus
                # the shard re-deal bookkeeping), the gate reopens
                with self._inv_span("invocation.commit"):
                    with self._quiesced():
                        self.ot.commit_invocation(self._pending)
                self.metrics.record_invocation(wall, overlapped=True)
                self._inv_wall_ewma = 0.7 * self._inv_wall_ewma + 0.3 * wall
                committed = True
            else:
                fenced = True
        self._pending = None
        self._inflight = None
        self._requests_since_invocation = 0
        if committed:
            self._note_invocation_success()
            # the commit may have re-dealt the shard map along the enhanced
            # partition (shard_map_source="partition"); re-pack and upload
            # now, on the worker between batches, so the next overlapped
            # invocation starts from a warm re-dealt layout
            self._warm_devices()
            self._publish_commit()
            self._invocation_span.end(committed=True, wall_s=wall)
            self._clear_invocation_trace()
            if self._snapshotter is not None and self.cfg.snapshot_on_commit:
                self.snapshot(sync=False)
        else:
            self._invocation_span.end(
                committed=False, fenced=fenced,
                error=("" if self._invocation_error is None
                       else repr(self._invocation_error)))
            self._clear_invocation_trace()
            if not fenced and self._kernel_error is None:
                # a fenced commit is the fence working, not a device fault —
                # it must not walk the backend ladder
                self._note_invocation_failure()

    def _check_watchdog(self) -> None:
        """Abort-and-abandon an overlapped run that blew its timeout.

        The run is cancelled cooperatively (``InvocationAborted`` at the
        next iteration boundary) and moved to the zombie list; serving
        continues immediately on the old partition, while ingest and new
        invocations wait for the zombie to actually exit."""
        timeout = self.cfg.invocation_timeout_s
        if timeout is None or self._inflight is None:
            return
        if time.perf_counter() - self._invocation_t0 < timeout:
            return
        self._abort_flag.set()
        self._abandoned.append(self._inflight)
        err = TimeoutError(
            f"invocation exceeded watchdog timeout ({timeout:g}s); "
            "aborted and abandoned")
        log.warning(str(err))
        self._invocation_error = err
        self.metrics.record_watchdog_abort()
        self.metrics.record_invocation_failure()
        self.obs.recorder.record("watchdog_abort", timeout_s=float(timeout))
        self.obs.recorder.trigger("degradation:watchdog_abort")
        self._invocation_span.end(committed=False, aborted=True,
                                  error=str(err))
        self._clear_invocation_trace()
        self._pending = None
        self._inflight = None
        # fresh event: the zombie holds (and will set) the old one
        self._invocation_done = threading.Event()
        self._note_invocation_failure()

    def _zombies_active(self) -> bool:
        if self._abandoned:
            self._abandoned = [t for t in self._abandoned if t.is_alive()]
        return bool(self._abandoned)

    # -- degradation ladder ---------------------------------------------------
    def _note_invocation_failure(self) -> None:
        # the consecutive count only drives the retry backoff now; the
        # demotion decision belongs to the breaker (rate-over-window with
        # a consecutive-tail clause — see ServeLoopConfig.control)
        self._consec_invocation_failures += 1
        backoff = (self.cfg.invocation_retry_backoff_s
                   * 2 ** (self._consec_invocation_failures - 1))
        self._backoff_until = time.monotonic() + backoff
        if self._backend_breaker.record_failure():
            self._fall_back_backend()
            # each rung starts with a clean window: failures that demoted
            # off the old rung are not evidence against the new one
            self._backend_breaker.reset()

    def _fall_back_backend(self) -> None:
        cur = self.ot.taper.config.field_backend
        try:
            i = FIELD_BACKEND_LADDER.index(cur)
        except ValueError:
            return
        if i + 1 >= len(FIELD_BACKEND_LADDER):
            return  # already at the bottom rung; keep retrying with backoff
        nxt = FIELD_BACKEND_LADDER[i + 1]
        self.ot.taper.set_field_backend(nxt)
        self.metrics.record_backend_fallback()
        self._consec_invocation_failures = 0
        self._healthy_since_fallback = 0
        self.obs.recorder.record("backend_fallback", from_backend=cur,
                                 to_backend=nxt)
        self.obs.recorder.trigger("degradation:backend_fallback")
        log.warning("field backend degraded %s -> %s after repeated "
                    "invocation failures", cur, nxt)

    def _note_invocation_success(self) -> None:
        self._consec_invocation_failures = 0
        self._backoff_until = 0.0
        self._backend_breaker.record_success()
        cur = self.ot.taper.config.field_backend
        if cur == self._base_backend:
            self._probe_after = self.cfg.backend_probe_after
            return
        self._healthy_since_fallback += 1
        if self._healthy_since_fallback < self._probe_after:
            return
        i = FIELD_BACKEND_LADDER.index(cur)
        try:
            base_i = FIELD_BACKEND_LADDER.index(self._base_backend)
        except ValueError:
            base_i = 0
        if i <= base_i:
            return
        up = FIELD_BACKEND_LADDER[i - 1]
        self.ot.taper.set_field_backend(up)
        self.metrics.record_backend_recovery()
        self.obs.recorder.record("backend_recovery", from_backend=cur,
                                 to_backend=up)
        # a failed probe falls straight back down (the ladder counters
        # re-engage); doubling the dwell makes a flapping device converge
        # onto its stable rung instead of oscillating
        self._probe_after *= 2
        self._healthy_since_fallback = 0
        log.info("field backend probing recovery %s -> %s", cur, up)

    def _join(self, t: threading.Thread, deadline: float, what: str) -> None:
        t.join(max(0.0, deadline - time.monotonic()))
        if t.is_alive():
            self._abort_flag.set()
            raise TimeoutError(f"stop: {what} still running after "
                               f"{self.cfg.stop_timeout_s:g} s; told to abort")

    def _finish_inflight(self, deadline: Optional[float] = None) -> None:
        if deadline is None:
            deadline = time.monotonic() + self.cfg.stop_timeout_s
        if self._inflight is not None:
            self._join(self._inflight, deadline, "the invocation")
            self._commit_if_done()
        for t in self._abandoned:
            # abort flag is set; the zombie exits at its next iteration
            # boundary — wait it out so shutdown leaves no thread behind
            self._join(t, deadline, "an abandoned invocation")
        self._abandoned = []

    # -- ingest ---------------------------------------------------------------
    def _apply_ingest(self) -> None:
        if self.ingest.depth() == 0:
            return
        with self._quiesced():
            self._apply_ingest_locked()

    def _apply_ingest_locked(self) -> None:
        applied = 0
        for merged, members in self.ingest.drain_groups():
            ing_ctx = (self.obs.tracer.new_trace() if self._obs_on
                       else NOOP_TRACE)
            ing_span = (self.obs.tracer.start("ingest.group", ing_ctx,
                                              members=len(members))
                        if ing_ctx.sampled else NOOP_SPAN)
            if self._replication is not None:
                # the fence is checked *before* the journal append: a
                # deposed or partitioned primary never writes divergent
                # records into the shared WAL, so its local state stays a
                # consistent stale prefix and rejoin is pure tail replay
                try:
                    self._replication.authorize(self._epoch, "ingest group")
                except FencedWrite as exc:
                    self._note_fenced(exc)
                    self.ingest.failed += len(members)
                    ing_span.end(fenced=True)
                    continue
            # WAL boundary: the group is journaled before it applies, and
            # its outcome (fold vs per-member fallback, member fates) right
            # after — replay reproduces the exact apply stream
            gseq = (self._journal.append_group(members)
                    if self._journal is not None else self._applied_seq + 1)
            flags = None
            try:
                if self._faults is not None:
                    self._faults.fire(SITE_INGEST_GROUP)
                self.ot.apply_mutations(merged)
                applied += 1
                mode = "merged"
            except (ValueError, InjectedFault):
                # a malformed producer batch (or injected poison) spoiled
                # the fold; apply the member batches individually so only
                # the bad one is lost (apply_mutations validates before
                # touching any state, so the failed fold left the graph
                # untouched)
                log.exception(
                    "coalesced ingest group failed; retrying "
                    "its %d member batches individually", len(members))
                mode, flags = "members", []
                for b in members:
                    try:
                        self.ot.apply_mutations(b)
                        applied += 1
                        flags.append(True)
                    except ValueError:
                        self.ingest.failed += 1
                        flags.append(False)
                        log.exception("dropping malformed ingest batch")
            if self._journal is not None:
                self._journal.append_outcome(
                    gseq, mode, flags if flags is not None
                    else [True] * len(members))
            self._applied_seq = gseq
            if self._replication is not None:
                try:
                    self._replication.publish_group(
                        self._epoch, gseq, members, mode,
                        flags if flags is not None else [True] * len(members),
                        int(self.g.version),
                        trace_id=(ing_ctx.trace_id if ing_ctx.sampled
                                  else None))
                except FencedWrite as exc:
                    # lost the lease between journal append and ship; the
                    # record is durable and followers pick it up from the
                    # journal tail, so only the push is skipped
                    self._note_fenced(exc)
            ing_span.end(seq=gseq, mode=mode)
        if applied:
            self._warm_devices()

    def _warm_devices(self) -> None:
        """Stream this rank's freshly patched shard onto its device now, off
        the invocation's critical path, so the next overlapped field
        evaluation starts from warm device buffers.  An upload failure is
        survivable — serving continues on the previous device buffers and
        the next field evaluation re-uploads lazily — but counts toward the
        degradation ladder like an invocation failure."""
        taper = self.ot.taper
        if taper.config.field_backend not in SHARDED_BACKENDS:
            return
        try:
            with self._inv_span("invocation.shard_upload"):
                self._warm_devices_inner()
        except BaseException:
            self.metrics.record_upload_failure()
            self._note_invocation_failure()
            log.exception("shard upload failed; serving continues on the "
                          "previous device state")

    def _warm_devices_inner(self) -> None:
        if self._faults is not None:
            self._faults.fire(SITE_SHARD_UPLOAD)
        import torch.distributed as dist

        from repro_torch.core.visitor import _sharded_device_arrays
        from repro_torch.launch.mesh import make_smoke_group

        taper = self.ot.taper
        pre = taper._pre
        # the field's process group (the one-rank group when none is set,
        # as the sharded field itself would make): S and this rank from it
        group = pre.get("_group")
        if group is None:
            group = pre["_group"] = make_smoke_group(taper.device)
        n_shards, rank = dist.get_world_size(group), dist.get_rank(group)
        token, order = pre.get("_shard_order") or ("stripe", None)
        sp = self.g.vm_packing_sharded(
            n_shards, cnt=self.g.cached_neighbor_label_counts(),
            order=order, order_token=token)
        _sharded_device_arrays(
            sp, pre, rank, taper.device, taper.config.halo_exchange,
            plain=taper.config.field_backend != "cuda_sharded")
