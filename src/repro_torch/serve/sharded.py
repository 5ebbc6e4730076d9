"""Threaded sharded serving across ranks: one loop serves, every rank carries
the field.

Under a sharded field backend (``cuda_sharded`` / ``torch_sharded``) each
rank of the field's process group holds one shard of the extroversion
field, and every invocation must run on all of them at once: the field's
collectives pair the ranks' runs.  The JAX package serves threaded in one
process with the field over the mesh; here the ranks are processes, so
they are made to agree:

* rank 0 runs the :class:`~repro_torch.serve.loop.ServingLoop` (queue,
  workers, sketch, trigger, commit, snapshots) with a :class:`RankLeader`;
* ranks 1..S-1 run a :class:`ShardFollower`, which receives from rank 0,
  in order, every ingest group (applied exactly as rank 0 applied it:
  folded or member by member), every invocation start (the
  ``PendingInvocation``'s arrays, the graph version it reads, the field
  rung), and every commit or abandonment;
* every rank runs the same ``OnlineTaper.run_invocation``, its field's
  collectives pairing rank 0's invocation thread with the followers; the
  run is bracketed by an agreement (:class:`Agreement`) on a gloo group of
  its own: before it every rank says whether it can start (rank 0's
  injected faults, a follower's); during it every rank polls before each
  of the field's collectives and at every abort poll (where rank 0's
  watchdog flag is read by all); after it every rank polls once more.  A
  rank that fails mid-run answers the next poll with its failure instead
  of entering the field's next collective, so every rank leaves the run
  at that poll and the ranks' errors are gathered: a follower's
  ``KernelError`` or failure reaches rank 0, which decides for all (no
  rank walks the ladder or gives up alone);
* each commit applies the same ``commit_invocation`` on every rank, then
  the same shard re-deal and dirty-shard upload; rank 0 sends its
  partition's digest with the commit and a follower that differs raises.

Control messages go down a gloo group of their own (``down``), sent by a
thread of rank 0's and received by a thread of each follower's, so rank
0's worker never blocks on a follower and never interleaves with the
invocation thread's field collectives.  Rank 0 sends a heartbeat when it
has been silent for a quarter of ``ServeLoopConfig.stop_timeout_s``; a
follower that hears nothing for ``stop_timeout_s`` raises
``TimeoutError``, and every collective of the two groups times out after
it too.  A rank whose process dies inside the field leaves the others in
the field's collective until that group's own timeout.

:func:`replay_schedule` runs the schedule a threaded loop kept
(``ServeLoopConfig.record_schedule``: what rank 0 sends) inline in one
process, through any field backend: the partitions it commits are the
ranks'.

Usage (every rank of the default group, ``ot`` on the same graph and
partition everywhere)::

    if rank == 0:
        loop = ServingLoop(g, k, part, taper_config, policy, config).start()
        ...; loop.stop()
    else:
        ShardFollower(g, k, part, taper_config, policy, config).run()
"""
from __future__ import annotations

import datetime
import hashlib
import pickle
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.online import OnlinePolicy, OnlineTaper, PendingInvocation
from repro_torch.core.taper import InvocationAborted, TaperConfig
from repro_torch.core.visitor import SHARDED_BACKENDS
from repro_torch.device import DeviceLike
from repro_torch.graphs.graph import LabelledGraph
from repro_torch.kernels import KernelError
from repro_torch.serve.faults import SITE_INVOCATION, SITE_SHARD_UPLOAD
from repro_torch.utils import get_logger

log = get_logger("serve.sharded")


def digest(part: np.ndarray) -> str:
    """A partition vector's digest, as the commit carries it."""
    return hashlib.blake2b(np.ascontiguousarray(part).tobytes(), digest_size=16).hexdigest()


def field_group(ot: OnlineTaper):
    """The field's process group (the default group, made if there is none,
    as the sharded field would make it), pinned in the Taper's precompute."""
    from repro_torch.launch.mesh import make_smoke_group

    pre = ot.taper._pre
    if pre.get("_group") is None:
        pre["_group"] = make_smoke_group(ot.taper.device)
    return pre["_group"]


def ranks_of(ot: OnlineTaper) -> int:
    """How many ranks carry ``ot``'s field: the field group's size under a
    sharded backend, else 1."""
    if ot.taper.config.field_backend not in SHARDED_BACKENDS:
        return 1
    import torch.distributed as dist

    return dist.get_world_size(field_group(ot))


class ControlGroups:
    """The control groups over the field group's ranks, made collectively
    (every rank of the default group makes them, in the same order):
    ``down`` carries rank 0's messages, ``agree`` the invocation threads'
    agreement.  Both are gloo, with ``timeout_s`` on every collective."""

    def __init__(self, group, timeout_s: float):
        import torch.distributed as dist

        ranks = dist.get_process_group_ranks(group)
        timeout = datetime.timedelta(seconds=timeout_s)
        self.down = dist.new_group(ranks, timeout=timeout, backend="gloo")
        self.agree = dist.new_group(ranks, timeout=timeout, backend="gloo")
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.root = ranks[0]


class Agreement:
    """Collectives of the invocation threads on ``groups.agree``."""

    def __init__(self, groups: ControlGroups):
        self.groups = groups
        self.collectives = 0

    def gather(self, status) -> List:
        import torch.distributed as dist

        out: List = [None] * self.groups.size
        dist.all_gather_object(out, status, group=self.groups.agree)
        self.collectives += 1
        return out

    def poll(self, abort: bool = False, failed: bool = False) -> Tuple[bool, bool]:
        """Whether any rank asked to abort, and whether any rank failed."""
        import torch
        import torch.distributed as dist

        t = torch.tensor([int(abort), int(failed)], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.groups.agree)
        self.collectives += 1
        return bool(t[0]), bool(t[1])


class _PeerFailed(Exception):
    """Raised inside a run on every rank at the poll where a rank failed."""


def _status(exc: Optional[BaseException], uploads_failed: int = 0) -> Dict:
    err = None
    if exc is not None:
        err = ("kernel" if isinstance(exc, KernelError) else "error",
               f"{type(exc).__name__}: {exc}")
    return {"error": err, "uploads_failed": uploads_failed}


def _agreed_error(statuses: List[Dict]) -> BaseException:
    """The error every rank raises when some rank failed: a ``KernelError``
    if any rank's was one, naming the first such rank."""
    failed = [(r, s["error"]) for r, s in enumerate(statuses) if s["error"] is not None]
    kernel = [(r, e) for r, e in failed if e[0] == "kernel"]
    r, (_, text) = (kernel or failed)[0]
    cls = KernelError if kernel else RuntimeError
    return cls(f"rank {r}: {text}")


def run_agreed(ot: OnlineTaper, pending: PendingInvocation, agree: Agreement,
               abort: Callable[[], bool], pre_error: Optional[BaseException] = None,
               uploads_failed: int = 0) -> List[Dict]:
    """``ot.run_invocation(pending)`` on every rank at once.  Returns the
    ranks' start statuses (their upload failures since the last start);
    raises on every rank when any rank could not start (this rank's own
    ``pre_error`` as itself) or failed (at the poll after its failure: the
    polls come before each of the field's collectives, at each abort poll
    and after the run), and ``InvocationAborted`` on every rank at the
    abort poll where rank 0's ``abort()`` was true."""
    statuses = agree.gather(_status(pre_error, uploads_failed))
    if any(s["error"] is not None for s in statuses):
        raise pre_error if pre_error is not None else _agreed_error(statuses)

    def should_abort() -> bool:
        stop, failed = agree.poll(abort=abort())
        if failed:
            raise _PeerFailed
        return stop

    def before_collective() -> None:
        if agree.poll()[1]:
            raise _PeerFailed

    pre = ot.taper._pre
    pre["_before_collective"] = before_collective
    err, failed = None, False
    try:
        ot.run_invocation(pending, should_abort=should_abort)
    except InvocationAborted:
        raise
    except _PeerFailed:
        failed = True
    except BaseException as exc:        # agreed below
        err, failed = exc, True
        agree.poll(failed=True)         # the others' next poll
    else:
        failed = agree.poll()[1]        # a rank that failed after the last collective
    finally:
        pre.pop("_before_collective", None)
    if failed:
        ends = agree.gather(_status(err))
        raise err if err is not None else _agreed_error(ends)
    return statuses


# ---------------------------------------------------------------------------
# rank 0
# ---------------------------------------------------------------------------


class RankLeader:
    """Rank 0's side: a sender thread that broadcasts the loop's control
    messages on ``down`` in order (a heartbeat when silent), the agreement,
    and what followers reported at each start."""

    def __init__(self, ot: OnlineTaper, stop_timeout_s: float):
        self.groups = ControlGroups(field_group(ot), stop_timeout_s)
        self.agree = Agreement(self.groups)
        self.heartbeat_s = min(5.0, stop_timeout_s / 4)
        self.messages = 0
        self.bytes = 0
        self.error: Optional[BaseException] = None
        self._q: "queue.Queue[Dict]" = queue.Queue()
        self._lock = threading.Lock()
        self._uploads_failed = 0
        self._thread = threading.Thread(target=self._send_loop, name="serve-ranks-send",
                                        daemon=True)
        self._thread.start()

    def send(self, msg: Dict) -> None:
        """Queue one message (``kind``, ``backend`` and what the follower
        reads of that kind) for the followers; returns at once."""
        self._q.put(msg)

    def _send_loop(self) -> None:
        import torch
        import torch.distributed as dist

        down, root = self.groups.down, self.groups.root
        while True:
            try:
                msg = self._q.get(timeout=self.heartbeat_s)
            except queue.Empty:
                msg = {"kind": "heartbeat"}
            blob = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
            try:
                dist.broadcast(torch.tensor([len(blob)], dtype=torch.int64), src=root,
                               group=down)
                dist.broadcast(torch.frombuffer(bytearray(blob), dtype=torch.uint8),
                               src=root, group=down)
            except BaseException as exc:
                self.error = exc
                log.exception("control message to the followers failed")
                return
            self.messages += 1
            self.bytes += len(blob) + 8
            if msg["kind"] == "stop":
                return

    def run_invocation(self, ot: OnlineTaper, pending: PendingInvocation,
                       abort: Callable[[], bool], pre_error: Optional[BaseException]) -> None:
        statuses = run_agreed(ot, pending, self.agree, abort, pre_error)
        with self._lock:
            self._uploads_failed += sum(s["uploads_failed"] for s in statuses[1:])

    def take_upload_failures(self) -> int:
        """Follower upload failures reported since the last call."""
        with self._lock:
            n, self._uploads_failed = self._uploads_failed, 0
        return n

    def close(self, deadline: float) -> None:
        """Send ``stop`` and wait (until ``deadline``) for it to go out."""
        self._q.put({"kind": "stop"})
        self._thread.join(max(0.0, deadline - time.monotonic()))
        if self._thread.is_alive():
            raise TimeoutError("stop: the followers did not take the stop message")


# ---------------------------------------------------------------------------
# what a follower (and a replay) does with each message
# ---------------------------------------------------------------------------


def _set_rung(ot: OnlineTaper, backend: str) -> None:
    """``ot``'s field on ``backend`` (the ladder's rungs, or the one it
    runs on: ``torch_sharded`` is on no ladder)."""
    if backend != ot.taper.config.field_backend:
        ot.taper.set_field_backend(backend)


class _Applier:
    """Applies rank 0's messages to an ``OnlineTaper``: the follower's state
    machine, shared with :func:`replay_schedule`."""

    def __init__(self, ot: OnlineTaper, backend: Optional[str] = None, keep: bool = True):
        self.ot = ot
        #: a fixed rung for a replay (None: the rung each message names)
        self.backend = backend
        self.keep = keep
        self.pending: Optional[PendingInvocation] = None
        #: the partition after each commit (when ``keep``)
        self.commits: List[np.ndarray] = []
        self.n_starts = 0
        self.n_commits = 0

    def _rung(self, msg: Dict) -> None:
        _set_rung(self.ot, self.backend or msg["backend"])

    def ingest(self, msg: Dict) -> bool:
        """Apply each group as rank 0 did; True when any applied."""
        self._rung(msg)
        applied = False
        for grp in msg["groups"]:
            if grp["mode"] == "merged":
                self.ot.apply_mutations(grp["merged"])
                applied = True
            else:
                for b, ok in zip(grp["members"], grp["flags"]):
                    if ok:
                        self.ot.apply_mutations(b)
                        applied = True
        if int(self.ot.g.version) != msg["version"]:
            raise RuntimeError(f"graph version {self.ot.g.version} after ingest, "
                               f"rank 0's {msg['version']}")
        return applied

    def start(self, msg: Dict) -> PendingInvocation:
        self._rung(msg)
        g = self.ot.g
        if int(g.version) != msg["version"] or g.n != msg["n_snapshot"]:
            raise RuntimeError(f"invocation starts on graph version {msg['version']} "
                               f"(n={msg['n_snapshot']}); this rank has {g.version} (n={g.n})")
        self.pending = PendingInvocation(
            reason=msg["reason"], tick=msg["tick"], n_snapshot=msg["n_snapshot"],
            part_snapshot=msg["part_snapshot"], workload=msg["workload"],
            frontier=msg["frontier"], dirty_snapshot=msg["dirty_snapshot"])
        self.n_starts += 1
        return self.pending

    def commit(self, msg: Dict) -> np.ndarray:
        self._rung(msg)
        if self.pending is None or self.pending.report is None:
            raise RuntimeError("rank 0 committed an invocation this rank did not finish")
        taper = self.ot.taper
        deals = taper._redeal_counter
        self.ot.commit_invocation(self.pending)
        self.pending = None
        redealt = taper._redeal_counter != deals
        if msg["redealt"] and not taper._sharded:
            # rank 0 re-dealt its shards along the commit, which drops its
            # field memo and with it the arrivals' placement prior; a
            # replay on one device drops its own alike
            taper._field_memo = None
        elif redealt != msg["redealt"]:
            raise RuntimeError("this rank's shard re-deal differs from rank 0's")
        part = self.ot.part
        self.n_commits += 1
        if digest(part) != msg["digest"]:
            raise RuntimeError(f"partition differs from rank 0's after commit "
                               f"{self.n_commits}")
        if self.keep:
            self.commits.append(part.copy())
        return part

    def abort(self, msg: Dict) -> None:
        self._rung(msg)
        self.pending = None


def replay_schedule(ot: OnlineTaper, schedule: List[Dict],
                    backend: Optional[str] = None) -> List[np.ndarray]:
    """Replay rank 0's logged schedule on ``ot`` (the same graph and
    partition the loop started from) inline in this process, every
    invocation through ``backend`` (default: the rung each message names).
    Returns the partition after each commit; raises where a commit's
    partition is not rank 0's."""
    ap = _Applier(ot, backend)
    for msg in schedule:
        kind = msg["kind"]
        if kind == "ingest":
            ap.ingest(msg)
        elif kind == "start":
            ot.run_invocation(ap.start(msg))
        elif kind == "commit":
            ap.commit(msg)
        elif kind == "abort":
            ap.abort(msg)
    return ap.commits


# ---------------------------------------------------------------------------
# ranks 1..S-1
# ---------------------------------------------------------------------------


class ShardFollower:
    """A rank other than 0 of threaded sharded serving (module doc): the
    same ``OnlineTaper`` as rank 0's loop, driven by rank 0's messages.

    Takes :class:`~repro_torch.serve.loop.ServingLoop`'s arguments;
    ``config`` gives ``stop_timeout_s`` (the silence after which
    :meth:`run` raises ``TimeoutError``), ``faults`` (the ``invocation``
    and ``shard_upload`` sites fire here as on rank 0) and
    ``record_schedule`` (keep each committed partition in ``commits``)."""

    def __init__(self, g: LabelledGraph, k: int, part: Optional[np.ndarray] = None,
                 taper_config: Optional[TaperConfig] = None,
                 policy: Optional[OnlinePolicy] = None, config=None,
                 device: DeviceLike = None):
        from repro_torch.serve.loop import ServeLoopConfig

        self.cfg = config or ServeLoopConfig()
        self.ot = OnlineTaper(g, k, part=part, config=taper_config,
                              policy=policy or OnlinePolicy(bootstrap_after_ticks=0),
                              device=device)
        tc = self.ot.taper.config
        if tc.field_backend is None:
            tc.field_backend = "cuda" if self.ot.taper.device.type == "cuda" else "torch"
        self._faults = self.cfg.faults
        self._ap = _Applier(self.ot, keep=self.cfg.record_schedule)
        self.kernel_error: Optional[KernelError] = None
        self.uploads_failed = 0
        self._uploads_unreported = 0
        self.aborts = 0
        self.messages = 0
        #: the invocation threads' agreement (made by :meth:`run`)
        self.agreement: Optional[Agreement] = None
        #: with ``record_schedule``: (kind, graph version, shards uploaded so
        #: far) after each message of rank 0's this rank applied
        self.trace: List[tuple] = []

    @property
    def commits(self) -> List[np.ndarray]:
        """The partition after each commit (with ``record_schedule``)."""
        return self._ap.commits

    def _warm(self) -> None:
        """The dirty-shard upload rank 0 does at the same point; a failure
        is reported to rank 0 at the next start."""
        from repro_torch.serve.loop import warm_shards

        if self.ot.taper.config.field_backend not in SHARDED_BACKENDS:
            return
        try:
            if self._faults is not None:
                self._faults.fire(SITE_SHARD_UPLOAD)
            warm_shards(self.ot)
        except BaseException:
            self.uploads_failed += 1
            self._uploads_unreported += 1
            log.exception("shard upload failed; rank 0 decides")

    def _recv_loop(self, groups: ControlGroups, inbox: "queue.Queue") -> None:
        import torch
        import torch.distributed as dist

        while True:
            try:
                n = torch.zeros(1, dtype=torch.int64)
                dist.broadcast(n, src=groups.root, group=groups.down)
                buf = torch.empty(int(n.item()), dtype=torch.uint8)
                dist.broadcast(buf, src=groups.root, group=groups.down)
            except BaseException as exc:
                inbox.put(exc)
                return
            msg = pickle.loads(buf.numpy().tobytes())
            inbox.put(msg)
            if msg["kind"] == "stop":
                return

    def _invoke(self, agree: Agreement, msg: Dict) -> None:
        pending = self._ap.start(msg)
        pre = None
        try:
            if self._faults is not None:
                self._faults.fire(SITE_INVOCATION)
        except BaseException as exc:
            pre = exc
        # rank 0 aborts or commits the run: its next message for it
        try:
            run_agreed(self.ot, pending, agree, lambda: False, pre,
                       self._uploads_unreported)
            self._uploads_unreported = 0
        except InvocationAborted:
            pass
        except KernelError as exc:
            self.kernel_error = exc
            log.error("invocation failed on a kernel: %s", exc)
        except Exception as exc:
            log.warning("invocation failed: %s", exc)

    def run(self) -> Dict:
        """Follow rank 0 until it sends ``stop``; returns this rank's
        counts.  Raises ``TimeoutError`` after ``stop_timeout_s`` of
        silence, and at the end the ``KernelError`` every rank agreed on."""
        timeout = self.cfg.stop_timeout_s
        groups = ControlGroups(field_group(self.ot), timeout)
        agree = self.agreement = Agreement(groups)
        inbox: "queue.Queue" = queue.Queue()
        recv = threading.Thread(target=self._recv_loop, args=(groups, inbox),
                                name="serve-ranks-recv", daemon=True)
        recv.start()
        while True:
            try:
                msg = inbox.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(f"rank {groups.rank}: no word from rank 0 for "
                                   f"{timeout:g} s") from None
            if isinstance(msg, BaseException):
                raise TimeoutError(f"rank {groups.rank}: rank 0 is gone ({msg})") from msg
            self.messages += 1
            kind = msg["kind"]
            if kind == "heartbeat":
                continue
            if kind == "ingest":
                if self._ap.ingest(msg):
                    self._warm()
            elif kind == "start":
                self._invoke(agree, msg)
            elif kind == "commit":
                self._ap.commit(msg)
                _set_rung(self.ot, msg["then"])
                self._warm()
            elif kind == "abort":
                self._ap.abort(msg)
                self.aborts += 1
            elif kind == "stop":
                break
            if self.cfg.record_schedule:
                ups = self.ot.taper._pre.get("_shard_uploads") or {}
                self.trace.append((kind, int(self.ot.g.version), ups.get("total_shards", 0)))
        recv.join(timeout)
        if self.kernel_error is not None:
            raise self.kernel_error
        return {"rank": groups.rank, "starts": self._ap.n_starts,
                "commits": self._ap.n_commits, "aborts": self.aborts,
                "messages": self.messages, "uploads_failed": self.uploads_failed,
                "agreements": agree.collectives}
