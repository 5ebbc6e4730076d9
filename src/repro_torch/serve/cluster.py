"""Replicated cluster serving: one primary loop, N WAL-shipped followers.

:class:`ClusterCoordinator` composes the pieces ``serve.replication``
provides into the deployment §6.2.4 of the paper assumes — a cluster that
keeps answering RPQ reads through replica crashes, shipping stalls and
network partitions:

* the **primary** is an ordinary :class:`~repro_torch.serve.loop.ServingLoop`
  (mutations, TAPER invocations, snapshots/WAL) with
  ``attach_replication`` wired to a ``ReplicationHub``: every journaled
  ingest group and every invocation commit is fenced then shipped;
* **followers** bootstrap exactly like a restarted node (snapshot fetch +
  journal tail replay) and stay current by applying the shipped stream —
  bitwise parity with the primary at every shipped seq;
* the :class:`ClusterRouter` answers reads: each query routes to the
  replica *owning* most of its start vertices under the partition-dealt
  owner fold (:func:`repro_torch.graphs.sharded_packing.shard_assignment` — the
  same span arithmetic ``ShardedVMPacking.owner_of`` uses on device), with
  per-class **bounded staleness** (a follower more than
  ``max_staleness_versions[cls]`` graph versions behind first catches up,
  then falls back to the primary) and per-class **deadline hedging** (a
  read exceeding ``slo_budget_s[cls]`` re-issues to an alternate replica
  and the faster answer wins — identical answers at parity, so hedging is
  pure tail-latency insurance).  Served paths are also accounted for
  **cross-replica ipt** — boundary crossings under the owner fold, the
  serving-level partition-quality metric — and folded into the primary's
  observation state so invocation triggers see the whole cluster's
  workload;
* **failover**: when primary heartbeats stop (crash or partition) past
  ``heartbeat_timeout_s``, the highest-applied-seq live follower promotes
  under a new epoch (:meth:`ClusterCoordinator.fail_over`): it catches up
  to the journal head, becomes a full ``ServingLoop`` over its replica
  state, publishes a *forced* epoch-opening commit frame (re-converging
  every replica, including the later-rejoining zombie) and a fresh
  snapshot.  The deposed node's late writes carry the stale epoch and are
  fenced; because the fence ran *before* every journal append, its state
  is a consistent stale prefix and :meth:`rejoin_demoted` turns it back
  into a follower by pure catch-up tail replay.

Device: every follower lives on the primary's device (``ot.taper.device``
of the primary ``ServingLoop``): the coordinator restores each bootstrap,
re-bootstrap and rejoin there, and a follower built over an ``OnlineTaper``
on another device raises.  A cluster over a primary on the card is
all-card; over ``"cpu"``, all-CPU.  A promoted follower's ``ServingLoop``
takes its device from its own ``OnlineTaper``.  A :class:`~repro_torch.kernels.KernelError` (a kernel
that failed to build or launch) is never a replica fault: the router's
read failover re-raises it, and :meth:`ClusterCoordinator.pump` lets the
primary's propagate — no failover, no ladder strike.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace as dc_replace
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.graphs.sharded_packing import majority_owner, shard_assignment
from repro_torch.kernels import KernelError
from repro_torch.obs import Observability
from repro_torch.obs.registry import Registry
from repro_torch.obs.trace import NOOP_SPAN, NOOP_TRACE
from repro_torch.serve.control import Breaker, ControlConfig, HedgeController
from repro_torch.serve.faults import FaultInjector, InjectedFault
from repro_torch.serve.loop import ServingLoop
from repro_torch.serve.replication import FollowerReplica, ReplicationHub
from repro_torch.utils import get_logger

log = get_logger("serve.cluster")


@dataclass
class ClusterConfig:
    n_followers: int = 2
    #: vertex block granularity of the owner fold (must match the packing's)
    block_n: int = 128
    max_results_per_query: int = 32
    #: missed-heartbeat window before a failover triggers
    heartbeat_timeout_s: float = 0.25
    #: per-class read staleness bound, in graph versions behind the primary
    #: (each applied mutation batch bumps the version once, so this is a
    #: mutation-log span); a staler follower catches up or the read falls
    #: back to the primary
    max_staleness_versions: Dict[str, int] = field(
        default_factory=lambda: {"hot": 4, "cold": 16})
    #: per-class deadline before a read hedges to a second replica
    slo_budget_s: Dict[str, float] = field(
        default_factory=lambda: {"hot": 0.05, "cold": 0.5})
    hedging: bool = True
    #: follower polls a gap may persist before a tail resync
    resync_after_polls: int = 2
    faults: Optional[FaultInjector] = None
    #: shared observability bundle (tracer / flight recorder / registry);
    #: defaults to the primary loop's bundle so cluster spans and the
    #: loop's invocation spans land in one place
    obs: Optional[Observability] = None
    # -- control loops ---------------------------------------------------------
    #: closed-loop serving protection (``serve.control``): per-follower
    #: serve breakers, breaker-gated ship channels, and adaptive hedge
    #: deadlines from the live ``router_latency_s`` quantiles (clamped to
    #: ``slo_budget_s``).  None keeps the static behaviour exactly.
    control: Optional[ControlConfig] = None


class ClusterRouter:
    """Owner-routed, staleness-bounded, deadline-hedged read path."""

    def __init__(self, coord: "ClusterCoordinator"):
        self.coord = coord
        #: the partition vector the owner map was folded from, held so a
        #: rebound vector can never pass for it
        self._owner_part: Optional[np.ndarray] = None
        self._owner_of: Optional[np.ndarray] = None
        self.routed = 0
        self.routed_by_slot: Dict[int, int] = {}
        self.hedged_requests = 0
        self.staleness_fallbacks = 0
        self.dead_redirects = 0
        self.read_failovers = 0
        self.cross_replica_ipt = 0.0
        #: per-SLO-class latency histograms, lazily bound to the registry
        self._lat_hists: Dict[str, Any] = {}
        # -- control loops (all None/zero without a ControlConfig) ------------
        ctl = coord.cfg.control
        #: histogram home: the shared registry when observability is on; a
        #: private one when only the control loops need the latencies (the
        #: shared disabled bundle's registry must never be written to)
        self._reg = (coord.obs.registry if coord.obs.enabled
                     else (Registry() if ctl is not None else None))
        #: adaptive hedge deadlines over the live per-class quantiles
        self._hedge = (HedgeController(self._reg, ctl)
                       if ctl is not None else None)
        #: per-follower-slot serve breakers (lazily bound)
        self._breakers: Dict[int, Breaker] = {}
        self.breaker_redirects = 0
        self.hedges_suppressed = 0

    def owners(self) -> np.ndarray:
        """Per-vertex owning replica slot under the current primary
        partition (cached until the partition vector is rebound).  The
        cache holds the vector it was folded from and compares identity:
        a key of ``id(part)`` (the reference's) passes a rebound vector
        that took the freed one's address for it, and serves the old
        owners."""
        part = self.coord.primary.ot.part
        if self._owner_part is not part:
            self._owner_of = shard_assignment(
                part, self.coord.n_replicas, block_n=self.coord.cfg.block_n)
            self._owner_part = part
        return self._owner_of

    def route(self, query) -> int:
        """Preferred slot for ``query``: majority owner of its start
        vertices (liveness/staleness gating happens at serve time)."""
        ex = self.coord.primary.executor
        plan = ex._enum_plan(query)
        g = self.coord.primary.g
        starts = np.nonzero(np.isin(g.labels, plan.first_labels))[0]
        return majority_owner(self.owners(), starts)

    def _breaker_for(self, slot: int) -> Optional[Breaker]:
        """This follower slot's serve breaker (None without control)."""
        ctl = self.coord.cfg.control
        if ctl is None:
            return None
        b = self._breakers.get(slot)
        if b is None:
            coord = self.coord
            b = self._breakers[slot] = Breaker(
                f"follower-{slot}",
                window=ctl.breaker_window,
                min_failures=ctl.breaker_min_failures,
                error_rate=ctl.breaker_error_rate,
                cooldown_s=ctl.breaker_cooldown_s,
                recorder=(coord.obs.recorder if coord.obs.enabled else None),
                clock=ctl.resolved_clock())
        return b

    def _usable(self, slot: int, cls: str) -> int:
        """Gate the routed slot on liveness, its serve breaker and the
        class staleness bound; falls back to the primary when the owner
        cannot serve in-bound."""
        coord = self.coord
        if slot == coord.primary_slot:
            return slot
        f = coord.followers.get(slot)
        if f is None or not f.alive:
            self.dead_redirects += 1
            return coord.primary_slot
        b = self._breaker_for(slot)
        if b is not None and not b.allow():
            # open breaker: route around the failing replica entirely (no
            # staleness probe either — that would also touch it)
            self.breaker_redirects += 1
            return coord.primary_slot
        bound = coord.cfg.max_staleness_versions.get(
            cls, max(coord.cfg.max_staleness_versions.values(), default=0))
        if f.version_lag > bound:
            f.catch_up()
            if not f.alive or f.version_lag > bound:
                self.staleness_fallbacks += 1
                return coord.primary_slot
        return slot

    def _alternate(self, slot: int, cls: str) -> Optional[int]:
        """Hedge target: the primary when the slow read was on a follower,
        else the freshest in-bound follower whose breaker admits traffic —
        hedging into an open breaker would just double the failure."""
        coord = self.coord
        if slot != coord.primary_slot:
            return coord.primary_slot
        bound = coord.cfg.max_staleness_versions.get(
            cls, max(coord.cfg.max_staleness_versions.values(), default=0))
        best: Optional[int] = None
        breaker_skips = 0
        for s, f in coord.followers.items():
            if not f.alive or f.version_lag > bound:
                continue
            b = self._breaker_for(s)
            if b is not None and not b.allow():
                breaker_skips += 1
                continue
            if (best is None
                    or f.applied_seq > coord.followers[best].applied_seq):
                best = s
        if best is None and breaker_skips:
            self.hedges_suppressed += 1
        return best

    def _serve_slot(self, slot: int, queries: Sequence,
                    max_results: int) -> Tuple[List, float]:
        coord = self.coord
        t0 = time.perf_counter()
        if slot == coord.primary_slot:
            res = coord.primary.executor.enumerate_paths_many(
                queries, max_results=max_results, part=coord.primary.ot.part)
        else:
            res = coord.followers[slot].serve(queries,
                                              max_results=max_results)
        return res, time.perf_counter() - t0

    def serve(self, queries: Sequence, cls: str = "hot",
              max_results: Optional[int] = None) -> List:
        """Answer a read batch; returns ``[(paths, ipt), ...]`` in input
        order.  Replica-side failures (injected serve faults, a crash
        between gate and execute) fail the read over to the primary."""
        coord = self.coord
        cfg = coord.cfg
        if max_results is None:
            max_results = cfg.max_results_per_query
        # first read answered after a failover joins the failover trace:
        # the cross-node crash → fence → promotion → first-answer story
        fo_sp = NOOP_SPAN
        if coord._failover_ctx is not None:
            fo_sp = coord.obs.tracer.start(
                "failover.first-answer", coord._failover_ctx,
                cls=cls, n_queries=len(queries))
            coord._failover_ctx = None
        by_slot: Dict[int, List[int]] = {}
        for i, q in enumerate(queries):
            slot = self._usable(self.route(q), cls)
            by_slot.setdefault(slot, []).append(i)
            self.routed += 1
            self.routed_by_slot[slot] = self.routed_by_slot.get(slot, 0) + 1
        out: List = [None] * len(queries)
        lats: List[float] = [0.0] * len(queries)
        budget = cfg.slo_budget_s.get(cls)
        # adaptive hedging: the deadline tracks the class's live latency
        # quantile, clamped into [hedge_floor_s, budget] — without control
        # loops it is exactly the static budget
        deadline = (self._hedge.deadline(cls, budget)
                    if self._hedge is not None else budget)
        for slot, idxs in by_slot.items():
            qs = [queries[i] for i in idxs]
            b = (self._breaker_for(slot)
                 if slot != coord.primary_slot else None)
            try:
                res, dt = self._serve_slot(slot, qs, max_results)
                if b is not None:
                    b.record_success()
            except KernelError:
                raise  # a broken kernel is no replica fault to fail over
            except (InjectedFault, RuntimeError):
                if slot == coord.primary_slot:
                    raise
                if b is not None:
                    b.record_failure()
                self.read_failovers += 1
                res, dt = self._serve_slot(coord.primary_slot, qs,
                                           max_results)
            per = dt / max(len(qs), 1)
            if cfg.hedging and deadline is not None and per > deadline:
                alt = self._alternate(slot, cls)
                if alt is not None and alt != slot:
                    ab = (self._breaker_for(alt)
                          if alt != coord.primary_slot else None)
                    try:
                        res2, dt2 = self._serve_slot(alt, qs, max_results)
                        if ab is not None:
                            ab.record_success()
                        self.hedged_requests += len(qs)
                        if dt2 < dt:
                            res, per = res2, dt2 / max(len(qs), 1)
                    except KernelError:
                        raise
                    except (InjectedFault, RuntimeError):
                        if ab is not None:
                            ab.record_failure()
                        # the hedge failing leaves the first answer
            for i, r in zip(idxs, res):
                out[i] = r
                lats[i] = per
        owner = self.owners()
        for paths, _ in out:
            for p in paths:
                if len(p) > 1:
                    ov = owner[np.asarray(p, dtype=np.int64)]
                    self.cross_replica_ipt += float((ov[1:] != ov[:-1]).sum())
        coord.primary.observe_served(
            list(queries), [ipt for _, ipt in out], latencies=lats)
        if self._reg is not None:
            h = self._lat_hists.get(cls)
            if h is None:
                h = self._lat_hists[cls] = self._reg.histogram(
                    "router_latency_s", cls=cls)
            for lat in lats:
                h.observe(lat)
        fo_sp.end(n_served=len(out))
        return out

    def stats(self) -> Dict[str, Any]:
        return {
            "routed": self.routed,
            "routed_by_slot": dict(self.routed_by_slot),
            "hedged_requests": self.hedged_requests,
            "hedged_rate": self.hedged_requests / max(self.routed, 1),
            "staleness_fallbacks": self.staleness_fallbacks,
            "dead_redirects": self.dead_redirects,
            "read_failovers": self.read_failovers,
            "cross_replica_ipt": self.cross_replica_ipt,
            "breaker_redirects": self.breaker_redirects,
            "hedges_suppressed": self.hedges_suppressed,
            "breaker_trips": sum(b.trips for b in self._breakers.values()),
            "breakers_open": sum(1 for b in self._breakers.values()
                                 if b.state != "closed"),
        }

    def collect(self) -> Dict[str, Any]:
        """Registry-collector hook (flattened by ``flatten_numeric``)."""
        return self.stats()


class ClusterCoordinator:
    """One primary ``ServingLoop`` + N ``FollowerReplica``s + the router
    (module doc).  Slots ``0..n_followers`` index the replica set;
    ``primary_slot`` names the one currently holding the write lease, and
    moves on failover."""

    def __init__(self, primary: ServingLoop,
                 config: Optional[ClusterConfig] = None,
                 policy=None, taper_config=None):
        if primary._journal is None:
            raise ValueError(
                "cluster serving needs a durable primary "
                "(ServeLoopConfig.snapshot_dir)")
        self.cfg = config or ClusterConfig()
        self.primary = primary
        self.directory = Path(primary.cfg.snapshot_dir)
        self._taper_config = (taper_config if taper_config is not None
                              else primary.ot.taper.config)
        self._policy = policy if policy is not None else primary.ot.policy
        #: every follower lives where the primary's field does
        self.device = primary.ot.taper.device
        self.faults = (self.cfg.faults if self.cfg.faults is not None
                       else primary.cfg.faults)
        self.obs = (self.cfg.obs if self.cfg.obs is not None
                    else primary.obs)
        #: forced failover trace awaiting its first answered read
        self._failover_ctx = None
        self.hub = ReplicationHub(journal=primary._journal,
                                  faults=self.faults)
        self.hub.primary_version = int(primary.g.version)
        self.hub.primary_seq = int(primary._applied_seq)
        primary.attach_replication(self.hub)
        # seed snapshot: followers bootstrap the way a restarted node does
        primary.snapshot(sync=True)
        self.primary_slot = 0
        self.followers: Dict[int, FollowerReplica] = {}
        for slot in range(1, self.cfg.n_followers + 1):
            self.followers[slot] = FollowerReplica.bootstrap(
                self.hub, f"replica-{slot}", self.directory,
                taper_config=self._taper_config, policy=self._policy,
                resync_after_polls=self.cfg.resync_after_polls,
                device=self.device)
            self._wire_channel_breaker(self.followers[slot])
        self.router = ClusterRouter(self)
        self.failovers = 0
        self.rejoins = 0
        self._primary_down = False
        #: deposed primaries by their old slot, awaiting rejoin_demoted()
        self._demoted: Dict[int, ServingLoop] = {}
        if self.obs.enabled:
            for slot, f in self.followers.items():
                self._wire_obs(f, slot)
            if self.faults is not None and self.faults.recorder is None:
                self.faults.recorder = self.obs.recorder
            self.obs.registry.register_collector("cluster", self.collect)
            self.obs.registry.register_collector("router",
                                                 self.router.collect)
            self.obs.registry.register_collector("hub", self.hub.collect)

    def _wire_channel_breaker(self, follower: FollowerReplica) -> None:
        """Breaker-gate this follower's ship channel (control loops only):
        an open link fast-fails sends instead of feeding a blackhole; the
        follower's tail resync repairs the gap after the half-open probe
        succeeds."""
        ctl = self.cfg.control
        if ctl is None:
            return
        follower.channel.breaker = Breaker(
            f"ship-{follower.name}",
            window=ctl.breaker_window,
            min_failures=ctl.breaker_min_failures,
            error_rate=ctl.breaker_error_rate,
            cooldown_s=ctl.breaker_cooldown_s,
            recorder=(self.obs.recorder if self.obs.enabled else None),
            clock=ctl.resolved_clock())

    def _wire_obs(self, follower: FollowerReplica, slot: int) -> None:
        """Hand the shared tracer/recorder to a follower so its applies
        join shipped traces, and expose its stats as a collector."""
        follower.tracer = self.obs.tracer
        follower.recorder = self.obs.recorder
        self.obs.registry.register_collector(f"follower_{slot}",
                                             follower.collect)

    # -- shape ----------------------------------------------------------------
    @property
    def n_replicas(self) -> int:
        return 1 + self.cfg.n_followers

    def node_for(self, slot: int):
        if slot == self.primary_slot:
            return self.primary
        return self.followers.get(slot)

    # -- client API -----------------------------------------------------------
    def serve(self, queries: Sequence, cls: str = "hot",
              max_results: Optional[int] = None) -> List:
        """Owner-routed read batch (see :meth:`ClusterRouter.serve`)."""
        return self.router.serve(queries, cls=cls, max_results=max_results)

    def submit_mutations(self, batch):
        """Writes go to the primary (single-writer; applied at its next
        pump round, journaled + shipped to followers)."""
        return self.primary.submit_mutations(batch)

    def pump(self, wait_s: float = 0.0) -> int:
        """One cluster scheduling round: failover check, primary pump
        (ingest/invocations/snapshots + heartbeat + shipping), follower
        polls, retention-floor update."""
        self.check_failover()
        served = 0
        if not self._primary_down:
            served = self.primary.pump(wait_s)
        for f in list(self.followers.values()):
            f.poll()
        self.hub.update_retention(
            include=[f.name for f in self.followers.values() if f.alive])
        self.check_failover()
        return served

    # -- failure injection (tests / benchmark drive these) --------------------
    def crash_primary(self) -> None:
        """Model primary process death: it stops pumping (so heartbeats
        stop), and its durable-state file handles are dropped at the
        promotion that follows."""
        self._primary_down = True

    def partition_primary(self) -> None:
        """Cut the primary's link: heartbeats are lost in flight and the
        write lease lapses (its durable writes fence until failover; after
        failover its epoch is stale and they fence forever)."""
        self.hub.partition_primary(True)

    # -- failover -------------------------------------------------------------
    def check_failover(self) -> bool:
        """Promote when the primary is known-dead or silent (no accepted
        heartbeat) past ``heartbeat_timeout_s``."""
        if not (self._primary_down or self.hub.primary_partitioned):
            return False
        silent_s = time.monotonic() - self.hub.last_heartbeat_mono
        if silent_s < self.cfg.heartbeat_timeout_s:
            return False
        self.obs.recorder.record(
            "heartbeat_lapse", slot=self.primary_slot, silent_s=silent_s,
            timeout_s=self.cfg.heartbeat_timeout_s)
        self.fail_over()
        return True

    def fail_over(self) -> ServingLoop:
        """Promote the best live follower under a new epoch (module doc).
        Deterministic choice: highest applied seq, then highest commit
        index, then lowest slot."""
        # one forced cross-node trace tells the whole failover story:
        # primary-crash → fence → promotion → (router) first answer
        tracer = self.obs.tracer
        fo_ctx = tracer.new_trace(force=True)
        root = tracer.start("failover", fo_ctx, from_slot=self.primary_slot)
        ctx = root.context()
        tracer.event("failover.primary-crash", ctx, slot=self.primary_slot,
                     crashed=self._primary_down,
                     partitioned=self.hub.primary_partitioned)
        live = [(slot, f) for slot, f in self.followers.items() if f.alive]
        if not live:
            raise RuntimeError("no live follower to promote")
        # catch everyone up first: promotion must not lose anything the
        # durable journal or the retained commit frames still hold
        for _, f in live:
            f.catch_up()
        live = [(slot, f) for slot, f in live if f.alive]
        if not live:
            raise RuntimeError("every follower died during catch-up")
        slot, best = max(
            live, key=lambda it: (it[1].applied_seq, it[1].commit_index,
                                  -it[0]))
        old, old_slot = self.primary, self.primary_slot
        epoch = self.hub.advance_epoch()
        tracer.event("failover.fence", ctx, epoch=epoch)
        promo = tracer.start("failover.promotion", ctx, slot=slot,
                             epoch=epoch, applied_seq=best.applied_seq)
        self.followers.pop(slot)
        self.hub.unregister(best.name)
        if self.obs.enabled:
            self.obs.registry.unregister_collector(f"follower_{slot}")
        if self._primary_down:
            # the dead process takes its file handles with it
            try:
                if old._snapshotter is not None:
                    old._snapshotter.close()
                if old._journal is not None:
                    old._journal.close()
            except Exception:
                log.exception("closing dead primary handles failed")
        loop_cfg = (dc_replace(old.cfg, obs=self.obs) if self.obs.enabled
                    else dc_replace(old.cfg))
        promoted = ServingLoop(config=loop_cfg, ot=best.ot)
        promoted._applied_seq = best.applied_seq
        self.hub.journal = promoted._journal
        promoted.attach_replication(self.hub, epoch)
        self.primary = promoted
        self.primary_slot = slot
        self._demoted[old_slot] = old
        self._primary_down = False
        self.failovers += 1
        # epoch-opening commit (the term-opening no-op): broadcast the
        # promoted node's full commit-volatile state so every replica —
        # and the zombie when it rejoins — re-converges on it bitwise.
        # The frame carries the failover trace id, so follower
        # ``replica.commit`` spans join this trace cross-node.
        promoted._invocation_ctx = promo.context()
        promoted._publish_commit(force=True)
        promoted._clear_invocation_trace()
        promoted._warm_devices()
        # fresh snapshot under the new epoch: later bootstraps and full
        # resyncs start from promoted state
        promoted.snapshot(sync=True)
        for f in self.followers.values():
            f.poll()
        promo.end()
        self.obs.recorder.record("promotion", slot=slot, epoch=epoch,
                                 applied_seq=best.applied_seq,
                                 demoted_slot=old_slot)
        self.obs.recorder.trigger("failover")
        root.end(promoted_slot=slot, epoch=epoch)
        if fo_ctx.sampled:
            self._failover_ctx = ctx
        log.warning("failover: slot %d promoted at epoch %d (seq %d); "
                    "slot %d demoted", slot, epoch, best.applied_seq,
                    old_slot)
        return promoted

    def _rejoin_commit_index(self, old: ServingLoop) -> int:
        """Retained commit frames the demoted node already holds: anything
        it published itself (or adopted) under an epoch up to its own.  The
        promoted node's forced epoch-open frame carries a *newer* epoch, so
        it is never treated as covered — rejoin applies it, repairing the
        RNG/prior divergence from the zombie's aborted run."""
        with self.hub._lock:
            idx = [f.commit_index for f in self.hub._commits
                   if int(f.epoch) <= old._epoch
                   and int(f.payload.get("invocations", 0))
                   <= int(old.ot.invocations)
                   and int(f.seq) <= old._applied_seq]
        return max(idx, default=0)

    def rejoin_demoted(self, slot: Optional[int] = None,
                       reuse_state: bool = True) -> FollowerReplica:
        """Bring a deposed primary back as a follower.  ``reuse_state=True``
        (the partition-zombie case): the fence kept every divergent write
        out of durable state, so its memory is a consistent stale prefix —
        rejoin is registration + catch-up tail replay.  ``False`` (the
        crashed-process case): full bootstrap from the latest snapshot."""
        if slot is None:
            slot = sorted(self._demoted)[0]
        old = self._demoted.pop(slot)
        name = f"replica-{slot}"
        if reuse_state:
            try:
                if old._snapshotter is not None:
                    old._snapshotter.close()
                if old._journal is not None:
                    old._journal.close()
            except Exception:
                log.exception("closing demoted primary handles failed")
            f = FollowerReplica(
                old.ot, self.hub, name, directory=self.directory,
                taper_config=self._taper_config, policy=self._policy,
                applied_seq=old._applied_seq,
                commit_index=self._rejoin_commit_index(old),
                resync_after_polls=self.cfg.resync_after_polls,
                device=self.device)
            f.catch_up()
        else:
            f = FollowerReplica.bootstrap(
                self.hub, name, self.directory,
                taper_config=self._taper_config, policy=self._policy,
                resync_after_polls=self.cfg.resync_after_polls,
                device=self.device)
        self.followers[slot] = f
        self.rejoins += 1
        self._wire_channel_breaker(f)
        if self.obs.enabled:
            self._wire_obs(f, slot)
        self.obs.recorder.record("rejoin", slot=slot,
                                 reuse_state=bool(reuse_state),
                                 applied_seq=f.applied_seq)
        return f

    # -- lifecycle / stats ----------------------------------------------------
    def stop(self, drain: bool = True) -> Dict[str, Any]:
        stats = self.stats()
        if not self._primary_down:
            self.primary.stop(drain=drain)
        for f in self.followers.values():
            f.crash()
        return stats

    def stats(self) -> Dict[str, Any]:
        """The primary's flat stats dict extended with cluster health:
        per-follower ship/apply lag and staleness, router counters, epoch
        and failover/fencing accounting (satellite: replication health)."""
        s = dict(self.primary.stats())
        s.update(self.router.stats())
        hub = self.hub.stats()
        alive = [f for f in self.followers.values() if f.alive]
        s.update({
            "n_replicas": self.n_replicas,
            "primary_slot": self.primary_slot,
            "failovers": self.failovers,
            "rejoins": self.rejoins,
            "cluster_epoch": hub["epoch"],
            "fencing_rejections": (hub["fencing_rejections"]
                                   + hub["partition_rejections"]),
            "last_stale_epoch": hub["last_stale_epoch"],
            "stale_heartbeats": hub["stale_heartbeats"],
            "max_seq_lag": max((f.seq_lag for f in alive), default=0),
            "max_version_lag": max((f.version_lag for f in alive),
                                   default=0),
            "staleness_bound_versions": dict(self.cfg.max_staleness_versions),
            "full_resyncs": sum(f.full_resyncs
                                for f in self.followers.values()),
            "tail_resyncs": sum(f.tail_resyncs
                                for f in self.followers.values()),
            "followers": {f.name: f.stats()
                          for f in self.followers.values()},
        })
        return s

    def collect(self) -> Dict[str, Any]:
        """Registry-collector hook: cluster health only (the primary loop
        and each follower register their own collectors)."""
        hub = self.hub.stats()
        alive = [f for f in self.followers.values() if f.alive]
        return {
            "n_replicas": self.n_replicas,
            "primary_slot": self.primary_slot,
            "failovers": self.failovers,
            "rejoins": self.rejoins,
            "epoch": hub["epoch"],
            "fencing_rejections": (hub["fencing_rejections"]
                                   + hub["partition_rejections"]),
            "stale_heartbeats": hub["stale_heartbeats"],
            "max_seq_lag": max((f.seq_lag for f in alive), default=0),
            "max_version_lag": max((f.version_lag for f in alive),
                                   default=0),
            "followers_alive": len(alive),
        }
