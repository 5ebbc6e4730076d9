"""WAL-shipping replication: follower replicas, epoch fencing, retention.

The single-node serving loop is crash-safe (snapshots + mutation WAL),
but a dead node still means downtime until replay finishes.  This
module turns the same durability artefacts into *replication*: follower
replicas that bootstrap exactly the way a restarted node does (snapshot
fetch + journal tail replay, :func:`repro_torch.serve.snapshot.restore_serving_state`)
and then stay current by applying the primary's WAL stream as it is
written, shipped frame-by-frame over an injectable in-memory transport.

Three frame kinds flow primary → follower over a :class:`ShipChannel`:

* ``"group"`` — one journaled coalesced mutation group, members plus its
  ``O``-record outcome, stamped with its WAL ``seq``.  Followers apply it
  through :func:`repro_torch.serve.snapshot.apply_journal_group`, the *same*
  fold crash restore uses, so a follower is bitwise-identical to the
  primary at every shipped seq (graph arrays, version, mutation-log
  spans, dirty bits, arrival placements).
* ``"commit"`` — an invocation commit's full volatile state (partition
  vector, RNG state, placement ``Pr`` prior, dirty bits, counters).
  Commits are *not* in the WAL (snapshot-on-commit covers single-node
  restore), so replication ships them explicitly; a follower adopts the
  payload only once its ``applied_seq`` reaches the frame's seq, keeping
  the partition vector and the graph in lock-step.  Commit frames carry a
  hub-assigned monotone ``commit_index``.
* ``"heartbeat"`` — primary liveness + applied seq/version/commit index;
  drives follower gap detection and the coordinator's failover timer.

**Loss recovery.**  The channel is deliberately unreliable (fault sites:
drop, delay, reorder, link partition — ``serve.faults``).  Followers
buffer out-of-order frames and apply strictly in order; a persistent gap
triggers a *tail resync*: group frames are re-read from the primary's
journal (:meth:`ReplicationHub.tail`) and commit frames from the hub's
retained list.  That is why WAL compaction must respect the replication
retention floor (``MutationJournal.set_retain_floor``, fed from
``min(acked seq)`` across followers): a lagging replica tail-replays
instead of re-fetching a snapshot.  Only when the journal has been
compacted past a follower's position (:class:`JournalGap` — e.g. the
follower was down across many snapshots) does it fall back to a full
re-bootstrap.

**Epoch fencing.**  The hub owns a monotone ``current_epoch`` (a
Raft-style term) and is the write-lease authority: the primary calls
:meth:`ReplicationHub.authorize` before every durable write — journaling
an ingest group, committing an invocation, publishing a snapshot.  A node
holding a stale epoch (a *zombie*: deposed but still running) gets
:class:`FencedWrite` and must drop the write; a partitioned primary is
refused the same way (lease semantics: a primary that cannot reach the
cluster stops accepting writes, so its state stays a consistent prefix
and it can later rejoin as a follower by pure catch-up replay).  On
failover the new primary publishes a *forced* commit frame (the epoch-
opening no-op) broadcasting its full commit-volatile state, which
re-converges every follower — including the demoted zombie, whose RNG may
have advanced inside an aborted invocation run — to bitwise parity.

**Device.**  A follower's ``OnlineTaper`` evaluates its field on a device
like the primary's: :meth:`FollowerReplica.bootstrap` and every full
re-bootstrap restore the snapshot onto the follower's ``device`` (the
cluster coordinator passes the primary's), and a follower built over an
existing ``OnlineTaper`` keeps that taper's device; a different ``device``
there raises.  Followers never evaluate a field; a promoted one does, on
its own device, from cold device inputs.
"""
from __future__ import annotations

import copy
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.device import DeviceLike, same_device
from repro_torch.serve.faults import (
    FaultInjector,
    InjectedFault,
    SITE_LINK_PARTITION,
    SITE_REPLICA_APPLY,
    SITE_REPLICA_SERVE,
    SITE_SHIP_DELAY,
    SITE_SHIP_DROP,
    SITE_SHIP_REORDER,
)
from repro_torch.serve.snapshot import (
    MutationJournal,
    _members_from_payload,
    _members_payload,
    apply_journal_group,
    restore_serving_state,
)
from repro_torch.utils import get_logger

log = get_logger("serve.replication")

KIND_GROUP = "group"
KIND_COMMIT = "commit"
KIND_HEARTBEAT = "heartbeat"


class FencedWrite(RuntimeError):
    """A durable write was rejected by the epoch fence (stale epoch, or a
    partitioned primary whose write lease lapsed)."""

    def __init__(self, stale_epoch: int, current_epoch: int, what: str = "",
                 partitioned: bool = False):
        self.stale_epoch = int(stale_epoch)
        self.current_epoch = int(current_epoch)
        self.what = what
        self.partitioned = bool(partitioned)
        if partitioned:
            msg = (f"write lease lost (link partitioned) at epoch "
                   f"{stale_epoch}: {what or 'write'} rejected")
        else:
            msg = (f"stale epoch {stale_epoch} (cluster at {current_epoch}): "
                   f"{what or 'write'} rejected")
        super().__init__(msg)


class JournalGap(RuntimeError):
    """Tail replay is impossible: the journal was compacted past the
    follower's position — a full snapshot re-bootstrap is required."""


@dataclass
class Frame:
    """One shipped replication frame (module doc for the three kinds)."""

    kind: str
    epoch: int
    #: WAL seq anchor: the group's own seq, or (commit/heartbeat) the
    #: primary's applied seq when the frame was emitted
    seq: int
    payload: Dict[str, Any] = field(default_factory=dict)
    #: hub-assigned monotone index (commit frames only)
    commit_index: int = 0
    #: epoch-opening commit emitted at promotion: applies by commit_index
    #: order like any other, but marks the re-convergence point
    force: bool = False


# ---------------------------------------------------------------------------
# commit-state shipping
# ---------------------------------------------------------------------------


def commit_payload(ot) -> Dict[str, Any]:
    """Copy everything an invocation commit touches that the WAL does not
    carry — the payload of a ``"commit"`` frame.  Captured on the primary
    right after ``commit_invocation`` (graph quiescent)."""
    pr = ot.placement_pr()
    return {
        "part": np.asarray(ot.part, np.int32).copy(),
        "dirty": np.asarray(ot._dirty, bool).copy(),
        "rng_state": copy.deepcopy(ot.taper._rng.bit_generator.state),
        "pr": None if pr is None else np.asarray(pr, np.float64).copy(),
        "invocations": int(ot.invocations),
        "tick": int(ot.tick),
        "last_invoke_tick": int(ot._last_invoke_tick),
        "freqs_at_invoke": dict(ot._freqs_at_invoke),
        "ipt_at_invoke": (None if ot._ipt_at_invoke is None
                          else float(ot._ipt_at_invoke)),
        "last_total_moves": (None if ot._last_total_moves is None
                             else int(ot._last_total_moves)),
        "version": int(ot.g.version),
        "n": int(ot.g.n),
    }


def adopt_commit_payload(ot, p: Dict[str, Any]) -> None:
    """Install a shipped commit payload on a replica's ``OnlineTaper``.
    Only valid at the commit's emission point in the stream — the replica's
    graph must match the payload's vertex count (the drain's total-order
    gating guarantees this; a covered stale commit is skipped there)."""
    if int(p["n"]) != int(ot.g.n):
        raise ValueError(
            f"commit payload for n={p['n']} vertices cannot apply to a "
            f"replica at n={ot.g.n} (apply the group stream first)")
    ot.part = np.asarray(p["part"], np.int32).copy()
    ot._dirty = np.asarray(p["dirty"], bool).copy()
    ot.taper._rng.bit_generator.state = copy.deepcopy(p["rng_state"])
    # the shipped Pr is the primary's post-commit placement prior; a stale
    # local field memo (a rejoining demoted primary has one) must not
    # shadow it, or arrival placements would diverge from the cluster
    ot.taper._field_memo = None
    ot.restore_placement_prior(p["pr"])
    ot.invocations = int(p["invocations"])
    ot.tick = int(p["tick"])
    ot._last_invoke_tick = int(p["last_invoke_tick"])
    ot._freqs_at_invoke = dict(p["freqs_at_invoke"])
    ot._ipt_at_invoke = (None if p["ipt_at_invoke"] is None
                         else float(p["ipt_at_invoke"]))
    ot._last_total_moves = (None if p["last_total_moves"] is None
                            else int(p["last_total_moves"]))


# ---------------------------------------------------------------------------
# transport
# ---------------------------------------------------------------------------


def _fire_site(faults: Optional[FaultInjector], site: str, name: str) -> None:
    """Fire a fault site both per-target (``site:name``) and bare."""
    if faults is None:
        return
    faults.fire(f"{site}:{name}")
    faults.fire(site)


class ShipChannel:
    """In-memory, deliberately unreliable primary→follower frame stream.

    Fault sites (armed bare or qualified ``"<site>:<name>"``) reinterpret
    the armed spec as network behaviour: ``ship_drop`` loses the frame,
    ``ship_delay`` holds it one extra poll round (late, out-of-order
    delivery), ``ship_reorder`` swaps it with the next frame.  A link
    partition (``set_partitioned`` or an armed ``link_partition`` site)
    blackholes the channel: sends are refused and frames in flight are
    lost, so healing requires the follower's tail-resync path."""

    def __init__(self, name: str, faults: Optional[FaultInjector] = None):
        self.name = name
        self._faults = faults
        self._lock = threading.Lock()
        self._inbox: List[Frame] = []
        #: (frame, polls until release): delayed frames surface *after*
        #: frames sent later, which is exactly the reorder the follower's
        #: sequence buffer must absorb
        self._delayed: List[List[Any]] = []
        self._swap: Optional[Frame] = None
        self.partitioned = False
        self.sent = 0
        self.dropped = 0
        self.delayed = 0
        self.reordered = 0
        self.blocked = 0
        #: highest group seq ever handed to send() (shipped, not acked)
        self.last_shipped_seq = 0
        #: optional circuit breaker (``serve.control.Breaker``, wired by
        #: the coordinator when control loops are on): an open link
        #: fast-fails the send instead of feeding a blackhole — the frame
        #: is still counted lost, and the follower's tail-resync path
        #: repairs the gap once the breaker's half-open probe succeeds
        self.breaker = None
        self.breaker_fastfail = 0

    def set_partitioned(self, flag: bool = True) -> None:
        self.partitioned = bool(flag)

    def _blackholed(self) -> bool:
        if self.partitioned:
            return True
        f = self._faults
        return f is not None and (
            f.armed(f"{SITE_LINK_PARTITION}:{self.name}")
            or f.armed(SITE_LINK_PARTITION))

    def send(self, frame: Frame) -> bool:
        """Ship one frame; returns False when the transport lost it."""
        if frame.kind == KIND_GROUP:
            self.last_shipped_seq = max(self.last_shipped_seq, int(frame.seq))
        if self.breaker is not None and not self.breaker.allow():
            # open link: don't even attempt the transport — the loss is
            # identical to a blackhole, but counted as a fast-fail and the
            # half-open probe (the first allowed send) re-tests the link
            self.breaker_fastfail += 1
            self.blocked += 1
            return False
        if self._blackholed():
            self.blocked += 1
            if self.breaker is not None:
                self.breaker.record_failure()
            return False
        try:
            _fire_site(self._faults, SITE_SHIP_DROP, self.name)
        except InjectedFault:
            self.dropped += 1
            if self.breaker is not None:
                self.breaker.record_failure()
            return False
        held = False
        try:
            _fire_site(self._faults, SITE_SHIP_DELAY, self.name)
        except InjectedFault:
            held = True
        reorder = False
        if not held:
            try:
                _fire_site(self._faults, SITE_SHIP_REORDER, self.name)
            except InjectedFault:
                reorder = True
        with self._lock:
            self.sent += 1
            if held:
                self.delayed += 1
                self._delayed.append([frame, 2])
            elif reorder:
                self.reordered += 1
                self._swap = frame
            else:
                self._inbox.append(frame)
                if self._swap is not None:
                    # the swapped-out frame lands *after* this newer one
                    self._inbox.append(self._swap)
                    self._swap = None
        if self.breaker is not None:
            self.breaker.record_success()
        return True

    def flush_in_flight(self) -> int:
        """Drop everything queued but undelivered (a crashed receiver's
        buffers die with its process).  Returns how many frames were lost."""
        with self._lock:
            lost = (len(self._inbox) + len(self._delayed)
                    + (1 if self._swap is not None else 0))
            self.dropped += lost
            self._inbox.clear()
            self._delayed.clear()
            self._swap = None
            return lost

    def receive(self) -> List[Frame]:
        """Drain deliverable frames (follower poll).  A blackholed link
        delivers nothing and loses whatever was in flight."""
        with self._lock:
            if self._blackholed():
                lost = (len(self._inbox) + len(self._delayed)
                        + (1 if self._swap is not None else 0))
                if lost:
                    self.dropped += lost
                    self._inbox.clear()
                    self._delayed.clear()
                    self._swap = None
                return []
            out = self._inbox
            self._inbox = []
            still: List[List[Any]] = []
            for item in self._delayed:
                item[1] -= 1
                if item[1] <= 0:
                    out.append(item[0])
                else:
                    still.append(item)
            self._delayed = still
            return out


# ---------------------------------------------------------------------------
# the hub
# ---------------------------------------------------------------------------


class ReplicationHub:
    """Cluster-side replication authority: epoch fence + write lease,
    per-follower ship channels, the retained commit-frame list, ack
    tracking, and journal-backed tail replay (module doc)."""

    def __init__(self, journal: Optional[MutationJournal] = None,
                 faults: Optional[FaultInjector] = None):
        self.journal = journal
        self._faults = faults
        self._lock = threading.RLock()
        self.current_epoch = 1
        self.channels: Dict[str, ShipChannel] = {}
        self._acked: Dict[str, int] = {}
        self._commits: List[Frame] = []
        self.primary_seq = int(journal.last_seq) if journal is not None else 0
        self.primary_version = 0
        self.last_heartbeat_mono = time.monotonic()
        self.heartbeats = 0
        self.stale_heartbeats = 0
        self.fencing_rejections = 0
        self.partition_rejections = 0
        self.last_stale_epoch: Optional[int] = None
        #: primary link state: True = the current primary cannot reach the
        #: cluster (its heartbeats are lost and its write lease lapses)
        self.primary_partitioned = False
        self.epochs_advanced = 0

    # -- membership ----------------------------------------------------------
    def register(self, name: str) -> ShipChannel:
        with self._lock:
            ch = ShipChannel(name, self._faults)
            self.channels[name] = ch
            self._acked.setdefault(name, 0)
            return ch

    def unregister(self, name: str) -> None:
        with self._lock:
            self.channels.pop(name, None)
            self._acked.pop(name, None)

    # -- fencing -------------------------------------------------------------
    def authorize(self, epoch: int, what: str = "") -> None:
        """Write-lease check: raises :class:`FencedWrite` for a stale epoch
        (zombie) or while the primary link is partitioned (lease lapsed)."""
        with self._lock:
            if int(epoch) != self.current_epoch:
                self.fencing_rejections += 1
                self.last_stale_epoch = int(epoch)
                raise FencedWrite(epoch, self.current_epoch, what)
            if self.primary_partitioned:
                self.partition_rejections += 1
                raise FencedWrite(epoch, self.current_epoch, what,
                                  partitioned=True)

    def advance_epoch(self) -> int:
        """Open a new epoch (failover).  Clears the partition flag — the
        promotee is on the cluster side of the partition by construction —
        and resets the heartbeat timer."""
        with self._lock:
            self.current_epoch += 1
            self.epochs_advanced += 1
            self.primary_partitioned = False
            self.last_heartbeat_mono = time.monotonic()
            return self.current_epoch

    def partition_primary(self, flag: bool = True) -> None:
        with self._lock:
            self.primary_partitioned = bool(flag)

    # -- primary-side publishing ---------------------------------------------
    def _broadcast(self, frame: Frame) -> None:
        with self._lock:
            channels = list(self.channels.values())
        for ch in channels:
            ch.send(frame)

    def heartbeat(self, epoch: int, applied_seq: int, version: int) -> bool:
        """Primary liveness beacon; ignored (counted) from a stale epoch or
        across a partitioned link, which is what starts the failover clock."""
        with self._lock:
            if int(epoch) != self.current_epoch or self.primary_partitioned:
                self.stale_heartbeats += 1
                return False
            self.heartbeats += 1
            self.last_heartbeat_mono = time.monotonic()
            self.primary_seq = max(self.primary_seq, int(applied_seq))
            self.primary_version = max(self.primary_version, int(version))
            frame = Frame(
                kind=KIND_HEARTBEAT, epoch=self.current_epoch,
                seq=int(applied_seq),
                payload={"version": int(version),
                         "commit_index": len(self._commits)})
        self._broadcast(frame)
        return True

    def publish_group(self, epoch: int, seq: int,
                      members: Sequence, mode: str,
                      applied: Sequence[bool], version_after: int,
                      trace_id: Optional[str] = None) -> Frame:
        """Ship one just-journaled-and-applied mutation group (the loop
        calls this right after writing the ``O`` record).  The frame
        carries the primary's commit index at publish time: a follower
        missing an earlier commit frame holds the group back (total-order
        gating) instead of applying past the commit's emission point.
        ``trace_id`` piggybacks the originating ingest trace on the frame
        so follower applies join it."""
        self.authorize(epoch, "group ship")
        with self._lock:
            frame = Frame(
                kind=KIND_GROUP, epoch=int(epoch), seq=int(seq),
                payload={
                    "members": _members_payload(members),
                    "mode": mode,
                    "applied": [bool(a) for a in applied],
                    "version_after": int(version_after),
                    "commit_index": len(self._commits),
                    **({"trace_id": str(trace_id)}
                       if trace_id is not None else {}),
                })
            self.primary_seq = max(self.primary_seq, int(seq))
            self.primary_version = max(self.primary_version,
                                       int(version_after))
        self._broadcast(frame)
        return frame

    def publish_commit(self, epoch: int, payload: Dict[str, Any],
                       seq: int, force: bool = False) -> Frame:
        """Ship one invocation commit's volatile state.  ``force=True`` is
        the promotion-time epoch-opening frame."""
        self.authorize(epoch, "invocation commit")
        with self._lock:
            frame = Frame(
                kind=KIND_COMMIT, epoch=int(epoch), seq=int(seq),
                payload=payload, commit_index=len(self._commits) + 1,
                force=force)
            self._commits.append(frame)
        self._broadcast(frame)
        return frame

    # -- follower-side acks / retention ---------------------------------------
    def ack(self, name: str, applied_seq: int) -> None:
        with self._lock:
            if name in self._acked:
                self._acked[name] = max(self._acked[name], int(applied_seq))

    def acked(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._acked)

    def update_retention(self,
                         include: Optional[Sequence[str]] = None) -> None:
        """Push ``min(acked seq)`` across (live) followers into the journal
        as its compaction floor.  ``include`` restricts the floor to the
        named followers — the coordinator passes only live ones, so a dead
        replica (which will re-bootstrap anyway) cannot pin the WAL."""
        if self.journal is None:
            return
        with self._lock:
            names = (list(self._acked) if include is None
                     else [n for n in include if n in self._acked])
            floor = min((self._acked[n] for n in names), default=None) \
                if names else None
        self.journal.set_retain_floor(floor)

    def tail(self, after_seq: int, after_commit_index: int) -> List[Frame]:
        """Everything a gapped follower needs, re-read from durable state:
        group frames from the journal past ``after_seq`` (outcome records
        authoritative), retained commit frames past ``after_commit_index``,
        plus a closing heartbeat.  Raises :class:`JournalGap` when the
        journal no longer reaches back to ``after_seq``."""
        with self._lock:
            epoch = self.current_epoch
            pseq = self.primary_seq
            pver = self.primary_version
            commits = [f for f in self._commits
                       if f.commit_index > int(after_commit_index)]
            n_commits = len(self._commits)
            commit_seqs = [int(f.seq) for f in self._commits]
        frames: List[Frame] = []
        if self.journal is not None:
            groups = self.journal.replay(after_seq=int(after_seq))
            if groups and groups[0][0] != int(after_seq) + 1:
                raise JournalGap(
                    f"journal starts at seq {groups[0][0]}, follower needs "
                    f"{int(after_seq) + 1} (compacted past it)")
            if not groups and pseq > int(after_seq):
                raise JournalGap(
                    f"journal empty but primary is at seq {pseq}, follower "
                    f"at {int(after_seq)}")
            for seq, members, outcome in groups:
                oc = outcome or {}
                frames.append(Frame(
                    kind=KIND_GROUP, epoch=epoch, seq=int(seq),
                    payload={
                        "members": _members_payload(members),
                        "mode": oc.get("mode", "merged"),
                        "applied": oc.get("applied",
                                          [True] * len(members)),
                        # journal-sourced frames carry no version stamp;
                        # the follower skips the integrity check for them
                        "version_after": None,
                        # reconstruct the publish-time gate: a commit at
                        # seq < s was emitted before this group
                        "commit_index": sum(
                            1 for cs in commit_seqs if cs < int(seq)),
                    }))
        frames.extend(commits)
        frames.append(Frame(
            kind=KIND_HEARTBEAT, epoch=epoch, seq=pseq,
            payload={"version": pver, "commit_index": n_commits}))
        return frames

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "epoch": self.current_epoch,
                "epochs_advanced": self.epochs_advanced,
                "fencing_rejections": self.fencing_rejections,
                "partition_rejections": self.partition_rejections,
                "last_stale_epoch": (-1 if self.last_stale_epoch is None
                                     else self.last_stale_epoch),
                "primary_seq": self.primary_seq,
                "primary_version": self.primary_version,
                "heartbeats": self.heartbeats,
                "stale_heartbeats": self.stale_heartbeats,
                "acked": dict(self._acked),
                "retained_commits": len(self._commits),
            }

    def collect(self) -> Dict[str, Any]:
        """Metrics-registry collector (``stats`` is already numeric apart
        from per-follower nesting, which the registry flattens)."""
        return self.stats()


# ---------------------------------------------------------------------------
# follower replica
# ---------------------------------------------------------------------------


class FollowerReplica:
    """One read-serving replica driven by the shipped WAL stream.

    Holds a full copy of the serving state (every replica can answer any
    query — that is what fallback and hedging lean on); stays current by
    applying ``group`` frames strictly in seq order and ``commit`` frames
    in commit-index order once their seq is reached, buffering whatever
    arrives early.  A gap that survives ``resync_after_polls`` polls (or
    a detected jump) triggers a tail resync from the hub; a journal gap
    triggers a full re-bootstrap from the latest snapshot."""

    def __init__(self, ot, hub: ReplicationHub, name: str,
                 directory=None, taper_config=None, policy=None,
                 applied_seq: int = 0, commit_index: int = 0,
                 faults: Optional[FaultInjector] = None,
                 resync_after_polls: int = 2,
                 device: DeviceLike = None):
        if device is not None and not same_device(ot.taper.device, device):
            raise ValueError(
                f"replica {name}: its OnlineTaper is on {ot.taper.device}, "
                f"not on {device}")
        self.ot = ot
        #: where re-bootstraps restore the replica's OnlineTaper
        self.device = ot.taper.device
        self.hub = hub
        self.name = name
        self.directory = directory
        self._taper_config = taper_config
        self._policy = policy
        self._faults = faults if faults is not None else hub._faults
        self.resync_after_polls = int(resync_after_polls)
        self.channel = hub.register(name)
        from repro_torch.workload.executor import QueryExecutor

        self.executor = QueryExecutor(ot.g)
        self.applied_seq = int(applied_seq)
        self.commit_index = int(commit_index)
        self.alive = True
        self.crash_error: Optional[BaseException] = None
        self._gbuf: Dict[int, Frame] = {}
        self._cbuf: Dict[int, Frame] = {}
        self.known_primary_seq = self.applied_seq
        self.known_primary_version = int(ot.g.version)
        self.known_commit_index = self.commit_index
        self.known_epoch = hub.current_epoch
        self.applied_groups = 0
        self.applied_commits = 0
        self.covered_commits = 0
        self.tail_resyncs = 0
        self.full_resyncs = 0
        self.serve_errors = 0
        self.served = 0
        self._gap_polls = 0
        self._desynced = False
        #: observability hooks (wired by the cluster coordinator): the
        #: tracer joins frame-borne trace ids so a follower's apply shows
        #: up inside the originating ingest/commit trace; the recorder
        #: captures resync/rebootstrap transitions
        self.tracer = None
        self.recorder = None

    def _join_span(self, name: str, trace_id, **attrs):
        """Span joined to a frame-borne trace id (None → no span)."""
        if self.tracer is None or not trace_id:
            return None
        ctx = self.tracer.join(trace_id)
        return self.tracer.start(name, ctx, replica=self.name, **attrs)

    # -- bootstrap -----------------------------------------------------------
    @classmethod
    def bootstrap(cls, hub: ReplicationHub, name: str, directory,
                  taper_config=None, policy=None,
                  faults: Optional[FaultInjector] = None,
                  resync_after_polls: int = 2,
                  device: DeviceLike = None) -> "FollowerReplica":
        """Join the cluster the way a restarted node recovers: latest
        readable snapshot + journal tail replay, then catch up through the
        hub to the live head.  The restored ``OnlineTaper`` lives on
        ``device`` (default ``"cuda"``; pass ``"cpu"`` on the CPU)."""
        res = restore_serving_state(directory, taper_config=taper_config,
                                    policy=policy, device=device)
        ci = cls._covered_commit_index(hub, res.ot.invocations,
                                       res.journal_seq)
        f = cls(res.ot, hub, name, directory=directory,
                taper_config=taper_config, policy=policy,
                applied_seq=res.journal_seq, commit_index=ci,
                faults=faults, resync_after_polls=resync_after_polls)
        f.catch_up()
        return f

    @staticmethod
    def _covered_commit_index(hub: ReplicationHub, invocations: int,
                              journal_seq: int) -> int:
        """Highest retained commit index a freshly restored snapshot
        already includes (its invocation counter and seq both cover the
        frame); later commits apply through the normal buffered path."""
        with hub._lock:
            idx = [f.commit_index for f in hub._commits
                   if int(f.payload.get("invocations", 0)) <= int(invocations)
                   and int(f.seq) <= int(journal_seq)]
        return max(idx, default=0)

    # -- state ---------------------------------------------------------------
    @property
    def g(self):
        return self.ot.g

    @property
    def seq_lag(self) -> int:
        return max(0, int(self.hub.primary_seq) - self.applied_seq)

    @property
    def version_lag(self) -> int:
        """Staleness bound in graph versions — the mutation log's version
        span between the primary's head and this replica (each applied
        batch bumps the version exactly once, so this is also the number
        of un-applied mutation batches)."""
        return max(0, int(self.hub.primary_version) - int(self.ot.g.version))

    # -- frame stream --------------------------------------------------------
    def poll(self) -> int:
        """Drain the channel and apply what is contiguous; escalate a
        persistent gap to a tail resync.  Returns frames applied.  An
        injected ``replica_apply`` raise crashes the replica (it stops
        applying, serving and acking until :meth:`rejoin`)."""
        if not self.alive:
            return 0
        try:
            self._ingest_frames(self.channel.receive())
            progress = self._drain()
            if self._desynced:
                self._rebootstrap()
                self.full_resyncs += 1
                progress += 1
            elif self._behind():
                self._gap_polls += 1
                if self._gap_polls >= self.resync_after_polls:
                    progress += self._resync()
            else:
                self._gap_polls = 0
        except InjectedFault as exc:
            self.alive = False
            self.crash_error = exc
            log.warning("replica %s crashed: %s", self.name, exc)
            return 0
        if not self.channel._blackholed():
            self.hub.ack(self.name, self.applied_seq)
        return progress

    def catch_up(self) -> int:
        """Poll, then force an immediate tail resync if still behind —
        promotion, rejoin and the router's staleness gate call this.
        Unlike a passive poll this reads the head position straight off
        the hub: a freshly (re)registered channel has received no frames
        yet, so a rejoining node would otherwise believe it is current."""
        if not self.alive:
            return 0
        if not self.channel._blackholed():
            with self.hub._lock:
                self.known_primary_seq = max(self.known_primary_seq,
                                             int(self.hub.primary_seq))
                self.known_primary_version = max(
                    self.known_primary_version,
                    int(self.hub.primary_version))
                self.known_commit_index = max(self.known_commit_index,
                                              len(self.hub._commits))
        n = self.poll()
        if self.alive and self._behind():
            try:
                n += self._resync()
            except InjectedFault as exc:
                self.alive = False
                self.crash_error = exc
                return n
            if not self.channel._blackholed():
                self.hub.ack(self.name, self.applied_seq)
        return n

    def _behind(self) -> bool:
        return (bool(self._gbuf)
                or self.known_primary_seq > self.applied_seq
                or self.known_commit_index > self.commit_index)

    def _ingest_frames(self, frames: List[Frame]) -> None:
        for f in frames:
            self.known_primary_seq = max(self.known_primary_seq, int(f.seq))
            self.known_epoch = max(self.known_epoch, int(f.epoch))
            if f.kind == KIND_GROUP:
                if f.seq > self.applied_seq:
                    self._gbuf[int(f.seq)] = f
                va = f.payload.get("version_after")
                if va is not None:
                    self.known_primary_version = max(
                        self.known_primary_version, int(va))
            elif f.kind == KIND_COMMIT:
                if f.commit_index > self.commit_index:
                    self._cbuf[int(f.commit_index)] = f
                self.known_commit_index = max(self.known_commit_index,
                                              int(f.commit_index))
            elif f.kind == KIND_HEARTBEAT:
                self.known_primary_version = max(
                    self.known_primary_version,
                    int(f.payload.get("version", 0)))
                self.known_commit_index = max(
                    self.known_commit_index,
                    int(f.payload.get("commit_index", 0)))

    def _drain(self) -> int:
        """Apply buffered frames in the primary's total order.  Commits are
        checked first: a commit emitted at seq ``s`` applies as soon as the
        replica has reached ``s``.  A group frame is held back while its
        publish-time ``commit_index`` exceeds the replica's — applying it
        would grow the graph past a missing commit's emission point; the
        gap registers as :meth:`_behind` and a tail resync delivers the
        commit.  A *covered* stale commit (payload ``n`` below the current
        graph — only the restore-from-older-snapshot edge produces one) is
        skipped by advancing ``commit_index`` without adopting."""
        n = 0
        while True:
            cf = self._cbuf.get(self.commit_index + 1)
            if cf is not None and int(cf.seq) <= self.applied_seq:
                self._cbuf.pop(self.commit_index + 1)
                if int(cf.payload.get("n", self.ot.g.n)) < int(self.ot.g.n):
                    self.commit_index = int(cf.commit_index)
                    self.covered_commits += 1
                else:
                    self._apply_commit(cf)
                n += 1
                continue
            gf = self._gbuf.get(self.applied_seq + 1)
            if gf is not None and int(
                    gf.payload.get("commit_index",
                                   self.commit_index)) <= self.commit_index:
                self._gbuf.pop(self.applied_seq + 1)
                self._apply_group(gf)
                n += 1
                continue
            break
        # a resync may have overtaken buffered duplicates
        for s in [s for s in self._gbuf if s <= self.applied_seq]:
            del self._gbuf[s]
        for ci in [ci for ci in self._cbuf if ci <= self.commit_index]:
            del self._cbuf[ci]
        return n

    def _apply_group(self, f: Frame) -> None:
        _fire_site(self._faults, SITE_REPLICA_APPLY, self.name)
        sp = self._join_span("replica.apply", f.payload.get("trace_id"),
                             seq=int(f.seq))
        members = _members_from_payload(f.payload["members"])
        outcome = {"mode": f.payload.get("mode", "merged"),
                   "applied": f.payload.get("applied",
                                            [True] * len(members))}
        apply_journal_group(self.ot, members, outcome)
        self.applied_seq = int(f.seq)
        self.applied_groups += 1
        if sp is not None:
            sp.end(members=len(members))
        va = f.payload.get("version_after")
        if va is not None and int(va) != int(self.ot.g.version):
            # bitwise-parity invariant broken (should be impossible): a
            # full re-bootstrap is the only safe recovery
            log.error(
                "replica %s desynced at seq %d: version %d != shipped %d",
                self.name, self.applied_seq, self.ot.g.version, int(va))
            self._desynced = True
        else:
            self.known_primary_version = max(
                self.known_primary_version, int(self.ot.g.version))

    def _apply_commit(self, f: Frame) -> None:
        _fire_site(self._faults, SITE_REPLICA_APPLY, self.name)
        sp = self._join_span("replica.commit", f.payload.get("trace_id"),
                             commit_index=int(f.commit_index),
                             epoch=int(f.epoch), force=bool(f.force))
        adopt_commit_payload(self.ot, f.payload)
        self.commit_index = int(f.commit_index)
        self.applied_commits += 1
        if sp is not None:
            sp.end()

    def _resync(self) -> int:
        """Tail resync: re-fetch the missing stream from durable state.
        Silently impossible across a partitioned link (the hub is on the
        other side); falls back to a full re-bootstrap on a journal gap."""
        self._gap_polls = 0
        if self.channel._blackholed():
            return 0
        try:
            frames = self.hub.tail(self.applied_seq, self.commit_index)
        except JournalGap:
            self._rebootstrap()
            self.full_resyncs += 1
            return 1
        self._ingest_frames(frames)
        n = self._drain()
        self.tail_resyncs += 1
        if self.recorder is not None:
            self.recorder.record("tail_resync", replica=self.name,
                                 applied_seq=self.applied_seq,
                                 frames=len(frames))
        return n

    def _rebootstrap(self) -> None:
        if self.directory is None:
            raise RuntimeError(
                f"replica {self.name} needs a full re-bootstrap but has no "
                "snapshot directory")
        if self.recorder is not None:
            self.recorder.record("full_resync", replica=self.name,
                                 applied_seq=self.applied_seq)
        res = restore_serving_state(self.directory,
                                    taper_config=self._taper_config,
                                    policy=self._policy, device=self.device)
        from repro_torch.workload.executor import QueryExecutor

        self.ot = res.ot
        self.executor = QueryExecutor(res.ot.g)
        self.applied_seq = int(res.journal_seq)
        self.commit_index = self._covered_commit_index(
            self.hub, res.ot.invocations, res.journal_seq)
        self._gbuf.clear()
        self._cbuf.clear()
        self._desynced = False
        # the snapshot + its journal tail land us at the WAL head; pending
        # commit frames arrive from the hub's retained list
        try:
            self._ingest_frames(
                self.hub.tail(self.applied_seq, self.commit_index))
        except JournalGap:
            pass
        self._drain()

    # -- reads ---------------------------------------------------------------
    def serve(self, queries, max_results: int = 32):
        """Execute a read micro-batch against this replica's state (its own
        partition vector — at parity this is bitwise the primary's answer;
        behind it, a bounded-staleness answer)."""
        if not self.alive:
            raise RuntimeError(f"replica {self.name} is down")
        try:
            _fire_site(self._faults, SITE_REPLICA_SERVE, self.name)
        except InjectedFault:
            self.serve_errors += 1
            raise
        res = self.executor.enumerate_paths_many(
            queries, max_results=max_results, part=self.ot.part)
        self.served += len(queries)
        return res

    # -- lifecycle -----------------------------------------------------------
    def crash(self) -> None:
        """Test hook: kill the replica (stops applying/serving/acking).
        Frames in flight die with the process."""
        self.alive = False
        self.channel.flush_in_flight()

    def rejoin(self, reuse_state: bool = False) -> None:
        """Bring a crashed replica back.  ``reuse_state=False`` models a
        lost process: re-bootstrap from the latest snapshot + journal tail;
        ``True`` keeps the memory image (the fence/apply invariants make it
        a consistent prefix) and catches up.  Either way, nothing shipped
        during the outage survives in the transport — recovery must come
        from durable state (tail replay or snapshot), never from a
        conveniently-preserved network buffer."""
        self.channel.flush_in_flight()
        self.crash_error = None
        self.alive = True
        if not reuse_state:
            self._rebootstrap()
        self.catch_up()

    def stats(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "alive": int(self.alive),
            "applied_seq": self.applied_seq,
            "shipped_seq": self.channel.last_shipped_seq,
            "seq_lag": self.seq_lag,
            "version_lag": self.version_lag,
            "commit_index": self.commit_index,
            "applied_groups": self.applied_groups,
            "applied_commits": self.applied_commits,
            "covered_commits": self.covered_commits,
            "tail_resyncs": self.tail_resyncs,
            "full_resyncs": self.full_resyncs,
            "serve_errors": self.serve_errors,
            "served": self.served,
            "channel_dropped": self.channel.dropped,
            "channel_delayed": self.channel.delayed,
            "channel_reordered": self.channel.reordered,
            "channel_blocked": self.channel.blocked,
            "channel_breaker_fastfail": self.channel.breaker_fastfail,
        }

    def collect(self) -> Dict[str, Any]:
        """Metrics-registry collector (the non-numeric ``name`` field is
        dropped by the registry's flattening)."""
        return self.stats()
