"""Online TAPER driver: continuous partition enhancement under combined
workload *and* topology drift (paper §1: "incrementally adjust the
partitioning in reaction to changes in the graph topology, the query
workload, or both").

:class:`OnlineTaper` owns a mutable :class:`~repro_torch.graphs.graph.LabelledGraph`,
a partition vector, a :class:`~repro_torch.workload.sketch.FrequencySketch` of the
observed query stream and an accumulated *dirty frontier* of mutated
vertices.  Each tick the caller feeds it query observations
(:meth:`observe`) and topology deltas (:meth:`apply_mutations`); the
:class:`OnlinePolicy` then decides *when* a TAPER invocation is worth its
cost — not a fixed cadence but triggers on

* **topology**: the dirty frontier exceeding a fraction of the graph —
  served by a *mutation-local* invocation whose swap candidate queue is
  seeded from the frontier only (``Taper.invoke(frontier=...)``);
* **workload**: L1 drift of the sketched frequencies since the last
  invocation;
* **ipt regression**: a caller-measured ipt exceeding the post-invocation
  baseline by a configured ratio — additionally gated (when
  ``OnlinePolicy.min_ipt_gain_per_mb`` > 0) on the projected ipt saving
  beating the degree-proportional vertex-state bytes the invocation's
  expected moves would ship between partitions;
* **cadence**: a hard upper bound on ticks between invocations.

Brand-new vertices are placed greedily on arrival: each picks the partition
holding the most intra-partition traversal probability over its already-
placed neighbours (weighted by the last extroversion field's per-vertex
traversal probability ``Pr(v)`` when available), subject to the balance
cap — so the partitioning never degenerates between invocations.

The driver's :class:`~repro_torch.core.taper.Taper` evaluates its field on
``device`` (default ``"cuda"``: the ``vm_step`` kernel over each graph
version's CSR); everything else here is host logic in numpy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, Iterable, Optional

import numpy as np

from repro_torch.core.taper import Taper, TaperConfig, TaperReport
from repro_torch.device import DeviceLike
from repro_torch.graphs.graph import AppliedMutation, LabelledGraph, MutationBatch
from repro_torch.graphs.partition import hash_partition
from repro_torch.utils import get_logger

if TYPE_CHECKING:  # import cycle guard: workload.sketch imports repro_torch.core.rpq
    from repro_torch.workload.sketch import FrequencySketch

log = get_logger("core.online")


@dataclass
class OnlinePolicy:
    """When to spend a TAPER invocation (see module docstring)."""

    cadence: int = 8            # invoke at least every N ticks (fallback)
    min_interval: int = 1       # never invoke more often than this
    dirty_fraction: float = 0.02   # topology trigger: |dirty| >= frac * n
    drift_l1: float = 0.5       # workload trigger: L1(freqs, freqs@invoke)
    ipt_regression: float = 1.2  # ipt trigger: measured / measured@invoke
    frontier_only: bool = True  # topology-triggered invocations are local
    min_freq: float = 1e-4      # sketch noise floor for the workload
    #: estimated bytes of vertex state shipped per incident edge when a
    #: vertex migrates between partitions (degree-proportional model: a
    #: vertex's serialized adjacency + per-edge payload dominates its
    #: transfer cost on a real store)
    migration_bytes_per_edge: float = 64.0
    #: ipt-regression gate: invoke only when the projected per-tick ipt
    #: saving (measured - post-invocation baseline) per megabyte of
    #: projected migration traffic clears this threshold.  0 disables the
    #: gate (regression ratio alone decides).
    min_ipt_gain_per_mb: float = 0.0
    #: bootstrap trigger: with no invocation yet and a non-empty observed
    #: workload, invoke once ``tick >= bootstrap_after_ticks``.  ``None``
    #: disables it (the cadence/topology triggers decide, the historic
    #: behaviour); serving engines set 0 so the first fit happens as soon
    #: as traffic exists — together with the serving layer's request-based
    #: ``first_invocation_after`` gate this replaces the legacy
    #: ``GraphQueryEngine`` "huge counter" first-invocation sentinel.
    #: (Deliberately tick-based and named differently from the serving
    #: config's request-based knob.)
    bootstrap_after_ticks: Optional[int] = None
    #: serve-pressure coupling (``serve.control``): when the caller passes
    #: a [0, 1] pressure signal to :meth:`OnlineTaper.poll`, an invocation
    #: is *deferred* (trigger suppressed, counted in
    #: ``pressure_deferrals``) at pressure >= ``defer_above_pressure`` —
    #: an overloaded loop cannot afford the enhancement's wall cost — and
    #: the ipt-regression threshold is *relaxed* toward 1 by
    #: ``accel_factor`` at pressure <= ``accelerate_below_pressure`` (idle
    #: capacity is the cheapest time to repartition).  ``None`` (default)
    #: disables each coupling; with no pressure passed behaviour is
    #: exactly the historic policy.
    defer_above_pressure: Optional[float] = None
    accelerate_below_pressure: Optional[float] = None
    #: relaxed regression threshold = 1 + (ipt_regression - 1) * accel_factor
    accel_factor: float = 0.5


@dataclass
class OnlineStepReport:
    """Outcome of one :meth:`OnlineTaper.step` tick."""

    tick: int
    invoked: bool
    reason: str = ""
    dirty_before: int = 0
    report: Optional[TaperReport] = None


@dataclass
class PendingInvocation:
    """An invocation split into its observe/commit halves.

    :meth:`OnlineTaper.begin_invocation` snapshots everything the TAPER run
    needs (partition vector, workload, frontier, dirty mask) on the driver
    thread; :meth:`OnlineTaper.run_invocation` may then execute on a
    different thread — overlapping with query serving — while the driver
    keeps serving against the *old* partition vector.  The graph must not
    mutate while :meth:`~OnlineTaper.run_invocation` executes (serving
    loops defer ingest while a run is in flight); mutations landing after
    the run but before the commit are safe:
    :meth:`OnlineTaper.commit_invocation` swaps the partition atomically,
    grafting the enhanced snapshot-length prefix onto whatever the live
    vector has grown to and clearing only the dirty bits the invocation
    actually consumed — mid-flight dirt survives for the next one.
    """

    reason: str
    tick: int
    n_snapshot: int
    part_snapshot: np.ndarray
    workload: list
    frontier: Optional[np.ndarray]
    dirty_snapshot: np.ndarray
    report: Optional[TaperReport] = None


class OnlineTaper:
    """Serving-loop driver combining workload sketching, topology deltas and
    policy-gated TAPER invocations over one mutable graph."""

    def __init__(
        self,
        g: LabelledGraph,
        k: int,
        part: Optional[np.ndarray] = None,
        config: Optional[TaperConfig] = None,
        policy: Optional[OnlinePolicy] = None,
        sketch: Optional["FrequencySketch"] = None,
        device: DeviceLike = None,
    ):
        from repro_torch.workload.sketch import FrequencySketch

        self.g = g
        self.k = k
        self.policy = policy or OnlinePolicy()
        self.taper = Taper(g, k, config, device=device)
        self.sketch = sketch or FrequencySketch(half_life=4.0)
        self.part = (
            np.asarray(part, dtype=np.int32).copy()
            if part is not None else hash_partition(g.n, k)
        )
        if self.part.shape[0] != g.n:
            raise ValueError("part length != g.n")
        self._dirty = np.zeros(g.n, dtype=bool)
        self.tick = 0
        self.invocations = 0
        self._last_invoke_tick = 0
        self._freqs_at_invoke: Dict[str, float] = {}
        self._ipt_at_invoke: Optional[float] = None
        self._last_total_moves: Optional[int] = None
        #: invocations the policy wanted but serve pressure deferred
        self.pressure_deferrals = 0
        #: snapshot-restored traversal prior for arrival placement: a fresh
        #: process has no field memo yet, but bitwise recovery parity needs
        #: replayed placements to see the same ``Pr`` the crashed node used
        self._restored_pr: Optional[np.ndarray] = None

    # -- inputs ---------------------------------------------------------------
    def observe(self, queries: Iterable) -> None:
        """Feed one batch of observed query instances (one sketch tick)."""
        self.sketch.observe_batch(queries)

    def apply_mutations(self, batch: MutationBatch) -> AppliedMutation:
        """Apply a topology delta: mutate the graph in place, greedily place
        brand-new vertices, and fold the changed endpoints into the dirty
        frontier for the next mutation-local invocation."""
        return self.ingest(self.g.apply_mutations(batch))

    def ingest(self, applied: AppliedMutation) -> AppliedMutation:
        """Absorb a mutation already applied to ``self.g`` (placement +
        dirty-frontier bookkeeping only) — for callers that apply the graph
        delta themselves, e.g. to account maintenance cost separately.

        The record must be the graph's *latest* mutation and contiguous
        with this driver's state — a skipped or replayed record would
        desync the partition vector, so it fails fast instead."""
        if applied.version != self.g.version:
            raise ValueError(
                f"stale AppliedMutation: record version {applied.version} "
                f"!= graph version {self.g.version} (ingest immediately "
                "after each apply_mutations)")
        if self.part.shape[0] != applied.n_before:
            raise ValueError(
                f"non-contiguous AppliedMutation: tracked part has "
                f"{self.part.shape[0]} vertices, record expects "
                f"{applied.n_before}")
        grow = applied.n_after - applied.n_before
        if grow:
            self.part = np.concatenate(
                [self.part, np.full(grow, -1, np.int32)])
            self._dirty = np.concatenate(
                [self._dirty, np.ones(grow, dtype=bool)])
            self._place_new(np.arange(applied.n_before, applied.n_after))
        if not applied.is_noop:
            dirty = applied.dirty_vertices()
            self._dirty[dirty[dirty < self.g.n]] = True
        return applied

    def _last_field(self):
        memo = self.taper._field_memo
        return memo[1] if memo is not None else None

    def placement_pr(self) -> Optional[np.ndarray]:
        """The traversal-probability prior arrival placement runs against:
        the last evaluated field's ``Pr`` when one exists, else the prior a
        snapshot restore carried over (``restore_placement_prior``)."""
        fld = self._last_field()
        if fld is not None:
            return fld.pr
        return self._restored_pr

    def restore_placement_prior(self, pr: Optional[np.ndarray]) -> None:
        """Install a snapshot-restored ``Pr`` prior for arrival placement.
        Superseded by the first real field evaluation (the memo wins in
        :meth:`placement_pr`)."""
        self._restored_pr = (
            None if pr is None else np.asarray(pr, dtype=np.float64))

    def _place_new(self, vs: np.ndarray) -> None:
        """Greedy arrival placement: argmax over partitions of the placed
        neighbours' traversal-probability mass (paper's intra-partition
        traversal probability, approximated by the last field's ``Pr``),
        subject to the configured balance cap."""
        g, k = self.g, self.k
        sizes = np.bincount(self.part[self.part >= 0], minlength=k).astype(np.int64)
        max_size = int(np.floor(
            (1.0 + self.taper.config.balance_eps) * g.n / k))
        pr = self.placement_pr()
        for v in vs.tolist():
            nbrs = g.neighbors(v).astype(np.int64)
            nbrs = nbrs[self.part[nbrs] >= 0]
            dest = None
            if nbrs.size:
                if pr is not None:
                    w = np.where(nbrs < pr.shape[0], pr[np.minimum(
                        nbrs, pr.shape[0] - 1)], 0.0).astype(np.float64)
                    # unknown-probability neighbours still count a little,
                    # so a vertex wholly attached to new vertices is not
                    # placed blind
                    w = np.maximum(w, 1e-12)
                else:
                    w = np.ones(nbrs.size, dtype=np.float64)
                score = np.bincount(self.part[nbrs], weights=w, minlength=k)
                for p in np.argsort(-score):
                    if sizes[p] < max_size:
                        dest = int(p)
                        break
            if dest is None:
                dest = int(np.argmin(sizes))
            self.part[v] = dest
            sizes[dest] += 1

    def workload_drift(self, freqs: Optional[Dict[str, float]] = None) -> float:
        """L1 distance between the sketched frequencies now and at the last
        invocation (1.0-ish before any invocation: everything is new).
        ``freqs`` lets a caller that already computed the sketch snapshot
        (the per-tick policy loop) avoid recomputing it."""
        if freqs is None:
            freqs = self.sketch.frequencies(self.policy.min_freq)
        keys = set(freqs) | set(self._freqs_at_invoke)
        return sum(
            abs(freqs.get(h, 0.0) - self._freqs_at_invoke.get(h, 0.0))
            for h in keys)

    # -- the policy loop ------------------------------------------------------
    def _decide(self, measured_ipt: Optional[float],
                pressure: Optional[float] = None) -> Optional[str]:
        pol = self.policy
        since = self.tick - self._last_invoke_tick
        if since < pol.min_interval:
            return None
        reason = self._trigger(measured_ipt, pressure)
        if (reason is not None and pressure is not None
                and pol.defer_above_pressure is not None
                and pressure >= pol.defer_above_pressure):
            # overload: the loop cannot afford the enhancement's wall cost
            # right now; the trigger condition persists, so the invocation
            # fires as soon as pressure drops back below the gate
            self.pressure_deferrals += 1
            log.info("invocation (%s) deferred: serve pressure %.2f >= %.2f",
                     reason, pressure, pol.defer_above_pressure)
            return None
        return reason

    def _trigger(self, measured_ipt: Optional[float],
                 pressure: Optional[float]) -> Optional[str]:
        pol = self.policy
        since = self.tick - self._last_invoke_tick
        if (self.invocations == 0 and pol.bootstrap_after_ticks is not None
                and self.tick >= pol.bootstrap_after_ticks):
            return "bootstrap"
        if int(self._dirty.sum()) >= max(1, int(pol.dirty_fraction * self.g.n)):
            return "topology"
        # drift is only defined against a post-invocation baseline — before
        # the first invocation the bootstrap/cadence/topology triggers
        # decide (an empty baseline would read as ~1.0 drift on a
        # stationary workload)
        freqs = self.sketch.frequencies(pol.min_freq) if self.invocations else {}
        if freqs and self.workload_drift(freqs) >= pol.drift_l1:
            return "workload"
        ipt_threshold = pol.ipt_regression
        if (pressure is not None and pol.accelerate_below_pressure is not None
                and pressure <= pol.accelerate_below_pressure):
            # idle capacity: relax the regression threshold toward 1 so a
            # smaller ipt regression justifies spending the invocation now
            ipt_threshold = 1.0 + (pol.ipt_regression - 1.0) * pol.accel_factor
        if (measured_ipt is not None and self._ipt_at_invoke is not None
                and self._ipt_at_invoke > 0
                and measured_ipt / self._ipt_at_invoke >= ipt_threshold
                and self._migration_worthwhile(measured_ipt)):
            return "ipt"
        if since >= pol.cadence:
            return "cadence"
        return None

    def estimated_migration_bytes(self) -> float:
        """Projected vertex-state transfer cost of the next invocation.

        Moves are estimated from the last invocation's actual move count
        (falling back to the topology trigger's dirty threshold before any
        history exists) and each move ships degree-proportional state:
        ``avg_degree * migration_bytes_per_edge`` bytes per vertex."""
        g = self.g
        est_moves = (self._last_total_moves
                     if self._last_total_moves is not None
                     else max(1, int(self.policy.dirty_fraction * g.n)))
        avg_deg = g.m / max(g.n, 1)
        return est_moves * avg_deg * self.policy.migration_bytes_per_edge

    def _migration_worthwhile(self, measured_ipt: float) -> bool:
        """Gate the ipt-regression trigger on projected savings beating the
        migration cost (invoke only when the enhancement pays for
        the bytes it moves)."""
        threshold = self.policy.min_ipt_gain_per_mb
        if threshold <= 0:
            return True
        baseline = self._ipt_at_invoke
        if baseline is None:
            return True
        projected_gain = measured_ipt - baseline
        mb = self.estimated_migration_bytes() / 2**20
        if mb <= 0:
            return True
        return projected_gain / mb >= threshold

    def poll(self, measured_ipt: Optional[float] = None,
             pressure: Optional[float] = None) -> Optional[str]:
        """Advance one tick and return the policy's trigger reason *without*
        invoking — the decide-only half of :meth:`step`, for serving loops
        that run the invocation themselves (overlapped on another thread
        via :meth:`begin_invocation` / :meth:`commit_invocation`).

        ``pressure`` is the serving loop's [0, 1] overload signal
        (``serve.control.serve_pressure``): high pressure defers the
        invocation, low pressure relaxes the ipt-regression threshold
        (see :class:`OnlinePolicy`)."""
        self.tick += 1
        if (measured_ipt is not None and self._ipt_at_invoke is None
                and self.invocations):
            # first measurement after an invocation becomes the regression
            # baseline (the pre-invocation measure would never trigger)
            self._ipt_at_invoke = measured_ipt
        return self._decide(measured_ipt, pressure)

    def step(self, measured_ipt: Optional[float] = None) -> OnlineStepReport:
        """Advance one tick and invoke TAPER if the policy says so.

        ``measured_ipt`` (optional) is the caller's current ipt measurement
        for the live partitioning — it feeds the regression trigger and is
        recorded as the post-invocation baseline."""
        dirty_before = int(self._dirty.sum())
        reason = self.poll(measured_ipt)
        if reason is None:
            return OnlineStepReport(self.tick, False, "", dirty_before)
        report = self.invoke(reason=reason)
        return OnlineStepReport(
            self.tick, report is not None, reason, dirty_before, report)

    # -- invocation lifecycle (observe -> run -> commit) ----------------------
    def begin_invocation(
        self, reason: str = "manual"
    ) -> Optional[PendingInvocation]:
        """Snapshot the inputs of one TAPER invocation (driver thread).

        Returns ``None`` when there is no observed workload to fit yet.
        Topology-triggered invocations are mutation-local (frontier-seeded)
        when ``policy.frontier_only``; other reasons use the full queue."""
        workload = self.sketch.workload(self.policy.min_freq)
        if not workload:
            log.info("online invoke skipped: no observed workload yet")
            return None
        frontier = None
        if reason == "topology" and self.policy.frontier_only:
            frontier = np.nonzero(self._dirty)[0]
        return PendingInvocation(
            reason=reason,
            tick=self.tick,
            n_snapshot=self.g.n,
            part_snapshot=self.part.copy(),
            workload=workload,
            frontier=frontier,
            dirty_snapshot=self._dirty.copy(),
        )

    def run_invocation(self, pending: PendingInvocation,
                       should_abort=None) -> TaperReport:
        """Execute the snapshotted invocation — safe on a worker thread as
        long as the graph does not mutate until the run returns (serving
        loops defer ingest while a run is in flight).  ``should_abort`` is
        forwarded to :meth:`Taper.invoke` (watchdog cancellation)."""
        pending.report = self.taper.invoke(
            pending.part_snapshot, pending.workload,
            frontier=pending.frontier, should_abort=should_abort)
        return pending.report

    def commit_invocation(self, pending: PendingInvocation) -> TaperReport:
        """Atomically publish a finished invocation (driver thread).

        The live partition vector may have grown since the snapshot (greedy
        arrival placements committed after the run finished); the enhanced
        part covers the snapshot prefix and is grafted onto the live tail
        in one rebind — concurrent readers see either the old vector or the
        new one, never a torn mix.  Only the dirty bits captured at
        :meth:`begin_invocation` are cleared: topology dirt accumulated
        mid-flight stays for the next invocation."""
        report = pending.report
        if report is None:
            raise ValueError("commit_invocation before run_invocation")
        new_part = self.part.copy()
        n_snap = min(pending.n_snapshot, new_part.shape[0])
        new_part[:n_snap] = report.final_part.astype(np.int32)[:n_snap]
        self.part = new_part  # atomic rebind: serve threads read old or new
        # off the critical path (the swap is already published): re-deal the
        # sharded field's vertex layout along the just-committed enhanced
        # partition, so the next invocation's halo exchange follows it —
        # no-op unless shard_map_source="partition" and enough vertices
        # changed shard (Taper.maybe_redeal_shards)
        self.taper.maybe_redeal_shards(new_part)
        ds = pending.dirty_snapshot
        self._dirty[:ds.shape[0]] &= ~ds
        self._last_total_moves = report.total_moves
        self.invocations += 1
        self._last_invoke_tick = self.tick
        self._freqs_at_invoke = self.sketch.frequencies(self.policy.min_freq)
        self._ipt_at_invoke = None  # re-baselined by the next measured step
        log.info(
            "online invoke #%d (reason=%s): %d moves, objective %.4f",
            self.invocations, pending.reason, report.total_moves,
            report.objective[-1] if report.objective else float("nan"))
        return report

    def invoke(self, reason: str = "manual") -> Optional[TaperReport]:
        """Run one TAPER invocation now, synchronously (policy bypassed):
        :meth:`begin_invocation` -> :meth:`run_invocation` ->
        :meth:`commit_invocation` on the calling thread."""
        pending = self.begin_invocation(reason)
        if pending is None:
            return None
        self.run_invocation(pending)
        return self.commit_invocation(pending)
