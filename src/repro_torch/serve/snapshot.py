"""Durable serving-state snapshots + mutation write-ahead journal.

Crash-safety for the serving subsystem is two complementary pieces:

* **Snapshots** (:class:`ServingSnapshotter`) — the full serving state,
  atomically published by generalising ``CheckpointManager``'s temp-dir +
  ``os.replace`` pattern (:func:`repro_torch.train.checkpoint.atomic_dir_publish`):
  graph arrays, partition vector, frequency sketch, shard-map permutation,
  online-policy counters, the arrival-placement ``Pr`` prior, the swap
  engine's RNG state and the compacted mutation log with its version spans.
  :func:`capture_serving_state` copies everything on the worker thread
  (between micro-batches, when nothing is mutating); the write itself runs
  on a background thread, off the serving critical path — the same
  split-capture/async-write shape the ``begin_invocation`` /
  ``run_invocation`` overlap uses.  Each snapshot's ``arrays.npz`` carries a
  sha256 in the manifest, so a corrupted snapshot is *detected* at restore
  and the loader falls back to the next older one.

* **WAL** (:class:`MutationJournal`) — mutations are journaled on ingest,
  *before* they are applied: each drained coalesced group writes its member
  batches to an append-only, CRC-framed log, applies, then records the
  apply *outcome* (merged fold vs per-member fallback, per-member fates).
  A torn tail (crash mid-append) is truncated on re-open; replay stops at
  the first corrupt frame.  Restore = latest-readable snapshot + replay of
  the journal groups past the snapshot's ``journal_seq`` through
  ``OnlineTaper.apply_mutations`` — bitwise parity with a node that never
  crashed, because the exact apply stream (fold boundaries, version bumps,
  validation drops) and the arrival-placement inputs (partition prefix +
  restored ``Pr`` prior + swap-RNG state) are all reproduced.  Records
  covered by every *retained* snapshot are compacted away after each
  successful save.

* **Elastic restore** — ``restore_serving_state(..., n_shards=S)`` brings a
  snapshot up on a different shard count by re-folding the partition-dealt
  shard map with the existing movement-aware k→S fold
  (:func:`repro_torch.graphs.sharded_packing.partition_shard_order`);
  :func:`plan_elastic_restore` budgets the byte movement with
  ``train.elastic``'s reshard-plan schema.
"""
from __future__ import annotations

import io
import json
import hashlib
import os
import struct
import threading
import time
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.graphs.graph import (
    LabelledGraph,
    MutationBatch,
    mutation_log_from_state,
    mutation_log_state,
)
from repro_torch.train.checkpoint import atomic_dir_publish
from repro_torch.train.elastic import movement_plan
from repro_torch.utils import get_logger

log = get_logger("serve.snapshot")

SNAP_PREFIX = "snap_"
WAL_NAME = "wal.log"
_REC_MAGIC = b"TPR1"
_REC_HEADER = struct.Struct("<cQQ")  # kind, seq, payload length
_REC_CRC = struct.Struct("<I")
_KIND_GROUP = b"G"
_KIND_OUTCOME = b"O"


# ---------------------------------------------------------------------------
# mutation WAL
# ---------------------------------------------------------------------------


def _members_payload(members: Sequence[MutationBatch]) -> bytes:
    arrays: Dict[str, np.ndarray] = {"n": np.int64(len(members))}
    for i, b in enumerate(members):
        arrays[f"avl{i}"] = np.asarray(list(b.add_vertex_labels), np.int64)
        arrays[f"ae{i}"] = np.asarray(b.add_edges, np.int64).reshape(-1, 2)
        arrays[f"rme{i}"] = np.asarray(b.remove_edges, np.int64).reshape(-1, 2)
        arrays[f"rmv{i}"] = np.asarray(list(b.remove_vertices), np.int64)
        arrays[f"rl{i}"] = np.asarray(b.relabel, np.int64).reshape(-1, 2)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _members_from_payload(payload: bytes) -> List[MutationBatch]:
    with np.load(io.BytesIO(payload)) as d:
        return [
            MutationBatch(
                add_vertex_labels=d[f"avl{i}"].copy(),
                add_edges=d[f"ae{i}"].copy(),
                remove_edges=d[f"rme{i}"].copy(),
                remove_vertices=d[f"rmv{i}"].copy(),
                relabel=d[f"rl{i}"].copy(),
            )
            for i in range(int(d["n"]))
        ]


class MutationJournal:
    """Append-only, CRC-framed write-ahead log of the serving loop's
    mutation *apply stream*.

    The journaling boundary is the ingest drain: right before the loop
    applies a coalesced group, the group's member batches are journaled
    (:meth:`append_group`, a ``G`` record); right after the apply, the
    *outcome* is journaled (:meth:`append_outcome`, an ``O`` record) —
    whether the merged fold applied in one shot or fell back to per-member
    application, and which members survived validation.  Replay reproduces
    the apply stream exactly — same coalesced folds, same per-batch version
    bumps, same validation drops — which is what bitwise recovery parity
    (graph version, mutation-log spans, packing caches) rests on.  A group
    with no outcome record (crash mid-apply) replays through the standard
    try-merged-then-members path, which is deterministic for everything but
    an injected fault — and a crashed apply has no live outcome to match.

    Frame: ``magic | kind | seq u64 | len u64 | payload | crc32(payload)``.
    Thread-safe; ``sync=True`` fsyncs every append (durability against
    power loss, not just process death).  Re-opening a journal with a torn
    tail truncates the partial frame so later appends stay readable."""

    def __init__(self, path, sync: bool = False):
        self.path = Path(path)
        self.sync = bool(sync)
        self._lock = threading.RLock()
        self._fh = None
        self._last_seq = 0
        self.appended = 0
        #: bytes appended by this process (framing included); compaction
        #: does not lower it
        self.appended_bytes = 0
        #: replication retention floor: records with ``seq > retain_floor``
        #: are still needed by a registered follower's tail replay, so
        #: :meth:`compact` never drops past it even when every retained
        #: snapshot already covers them (``None`` = no followers registered)
        self.retain_floor: Optional[int] = None
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if self.path.exists():
            records, end = self._scan()
            if records:
                self._last_seq = max(seq for _, seq, _ in records)
            if end < self.path.stat().st_size:
                log.warning(
                    "journal %s has a torn tail (%d of %d bytes valid); "
                    "truncating", self.path, end, self.path.stat().st_size)
                with open(self.path, "r+b") as fh:
                    fh.truncate(end)

    @property
    def last_seq(self) -> int:
        with self._lock:
            return self._last_seq

    def _scan(self) -> Tuple[List[Tuple[bytes, int, bytes]], int]:
        """All valid ``(kind, seq, payload)`` frames and the offset where
        validity ends (start of the torn/corrupt tail, or EOF)."""
        out: List[Tuple[bytes, int, bytes]] = []
        data = self.path.read_bytes() if self.path.exists() else b""
        off = 0
        frame = len(_REC_MAGIC) + _REC_HEADER.size
        while off + frame <= len(data):
            if data[off:off + len(_REC_MAGIC)] != _REC_MAGIC:
                break
            kind, seq, plen = _REC_HEADER.unpack_from(
                data, off + len(_REC_MAGIC))
            body = off + frame
            end = body + plen + _REC_CRC.size
            if end > len(data):
                break
            payload = data[body:body + plen]
            (crc,) = _REC_CRC.unpack_from(data, body + plen)
            if zlib.crc32(payload) != crc:
                break
            out.append((kind, int(seq), payload))
            off = end
        return out, off

    def _write(self, kind: bytes, seq: int, payload: bytes) -> None:
        if self._fh is None:
            self._fh = open(self.path, "ab")
        rec = (_REC_MAGIC + _REC_HEADER.pack(kind, seq, len(payload))
               + payload + _REC_CRC.pack(zlib.crc32(payload)))
        self._fh.write(rec)
        self._fh.flush()
        if self.sync:
            os.fsync(self._fh.fileno())
        self.appended += 1
        self.appended_bytes += len(rec)

    def append_group(self, members: Sequence[MutationBatch]) -> int:
        """Journal one coalesced group's member batches *before* they are
        applied; returns the group's sequence number (1-based)."""
        payload = _members_payload(members)
        with self._lock:
            seq = self._last_seq + 1
            self._write(_KIND_GROUP, seq, payload)
            self._last_seq = seq
            return seq

    def append_outcome(self, group_seq: int, mode: str,
                       applied: Sequence[bool]) -> None:
        """Journal how group ``group_seq`` actually applied: ``mode`` is
        ``"merged"`` (the fold applied in one shot) or ``"members"``
        (per-member fallback), ``applied`` flags each member's fate."""
        payload = json.dumps(
            {"mode": mode, "applied": [bool(a) for a in applied]}
        ).encode()
        with self._lock:
            self._write(_KIND_OUTCOME, int(group_seq), payload)

    def replay(self, after_seq: int = 0
               ) -> List[Tuple[int, List[MutationBatch],
                               Optional[Dict[str, Any]]]]:
        """Every journaled group with ``seq > after_seq``, in order, as
        ``(seq, members, outcome-or-None)``.  Stops (silently, by
        construction) at a torn/corrupt tail."""
        with self._lock:
            records, _ = self._scan()
        outcomes: Dict[int, Dict[str, Any]] = {}
        groups: List[Tuple[int, bytes]] = []
        for kind, seq, payload in records:
            if kind == _KIND_GROUP:
                groups.append((seq, payload))
            elif kind == _KIND_OUTCOME:
                outcomes[seq] = json.loads(payload.decode())
        return [(seq, _members_from_payload(p), outcomes.get(seq))
                for seq, p in groups if seq > int(after_seq)]

    def set_retain_floor(self, seq: Optional[int]) -> None:
        """Install the replication retention floor: ``min(acked seq)``
        across registered followers (the hub updates it every pump round).
        A lagging replica keeps its tail-replay window alive this way
        instead of being forced into a full snapshot re-fetch."""
        with self._lock:
            self.retain_floor = None if seq is None else int(seq)

    def compact(self, upto_seq: int) -> int:
        """Drop records with ``seq <= upto_seq`` (covered by every retained
        durable snapshot), rewriting the file atomically.  Returns how many
        records were dropped.  The replication retention floor
        (:meth:`set_retain_floor`) clamps the cut: records a registered
        follower has not acknowledged survive snapshot-driven pruning."""
        with self._lock:
            if self.retain_floor is not None:
                upto_seq = min(int(upto_seq), self.retain_floor)
            records, _ = self._scan()
            keep = [r for r in records if r[1] > int(upto_seq)]
            if len(keep) == len(records):
                return 0
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            tmp = self.path.with_name(self.path.name + ".tmp")
            with open(tmp, "wb") as fh:
                for kind, seq, payload in keep:
                    fh.write(_REC_MAGIC
                             + _REC_HEADER.pack(kind, seq, len(payload))
                             + payload + _REC_CRC.pack(zlib.crc32(payload)))
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self.path)
            return len(records) - len(keep)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


# ---------------------------------------------------------------------------
# state capture
# ---------------------------------------------------------------------------


@dataclass
class ServingState:
    """One captured (host-side, already copied) serving state, ready to be
    written by :class:`ServingSnapshotter` on any thread."""

    arrays: Dict[str, np.ndarray]
    manifest: Dict[str, Any] = field(default_factory=dict)


def capture_serving_state(ot, journal_seq: int,
                          extra: Optional[Dict[str, Any]] = None
                          ) -> ServingState:
    """Copy the full serving state of an ``OnlineTaper`` (module doc).

    Must run where the graph and partition are quiescent — the serving
    worker between micro-batches, or any thread while the loop is stopped.
    ``journal_seq`` is the WAL sequence number of the last *applied*
    mutation batch: restore replays everything after it."""
    t0 = time.perf_counter()
    g = ot.g
    arrays: Dict[str, np.ndarray] = {
        "labels": g.labels.copy(),
        "src": g.src.copy(),
        "dst": g.dst.copy(),
        "row_ptr": g.row_ptr.copy(),
        "part": np.asarray(ot.part, np.int32).copy(),
        "dirty": ot._dirty.copy(),
    }
    mlog_arrays, mlog_meta = mutation_log_state(g.mutation_log)
    arrays.update(mlog_arrays)
    pr = ot.placement_pr()
    if pr is not None:
        arrays["placement_pr"] = np.asarray(pr, np.float64).copy()
    shard = ot.taper._pre.get("_shard_order")
    token = None
    n_shards = None
    if shard is not None and shard[1] is not None:
        token, pos = shard
        arrays["shard_pos"] = np.asarray(pos, np.int64).copy()
        n_shards = ot.taper._group_shards()
    manifest: Dict[str, Any] = {
        "format": 1,
        "kind": "serving_snapshot",
        # wall time is for humans reading the manifest; durations derived
        # from it would be skewed by NTP steps, so the capture cost is
        # measured separately on the monotonic clock and threaded into
        # ``ServingLoop.stats()`` as ``snapshot_capture_s``
        "time": time.time(),
        "wall_time_s": time.time(),
        "k": int(ot.k),
        "graph": {
            "n": int(g.n),
            "version": int(g.version),
            "label_names": list(g.label_names),
        },
        "journal_seq": int(journal_seq),
        "counters": {
            "tick": int(ot.tick),
            "invocations": int(ot.invocations),
            "last_invoke_tick": int(ot._last_invoke_tick),
            "freqs_at_invoke": dict(ot._freqs_at_invoke),
            "ipt_at_invoke": (None if ot._ipt_at_invoke is None
                              else float(ot._ipt_at_invoke)),
            "last_total_moves": (None if ot._last_total_moves is None
                                 else int(ot._last_total_moves)),
        },
        "sketch": ot.sketch.state_dict(),
        "rng_state": ot.taper._rng.bit_generator.state,
        "shard_order_token": token,
        "n_shards": n_shards,
        "field_backend": ot.taper.config.field_backend,
        "mutation_log": mlog_meta,
    }
    if extra:
        manifest["extra"] = dict(extra)
    manifest["capture_duration_s"] = time.perf_counter() - t0
    return ServingState(arrays=arrays, manifest=manifest)


# ---------------------------------------------------------------------------
# the snapshotter
# ---------------------------------------------------------------------------


class ServingSnapshotter:
    """Atomic, versioned serving snapshots with keep-N pruning, optional
    background writes (serialized, :class:`CheckpointManager`-style) and
    post-save WAL compaction."""

    def __init__(self, directory, keep: int = 3,
                 journal: Optional[MutationJournal] = None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = int(keep)
        self.journal = journal
        self._save_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self.saved = 0
        self.failures = 0
        self.last_wall_s = 0.0
        self.last_bytes = 0
        #: monotonic duration of the last state *capture* (host-side copy,
        #: from the manifest) vs ``last_wall_s``, the publish duration —
        #: the two halves of the snapshot cost surfaced in ``stats()``
        self.last_capture_s = 0.0

    # -- inventory -----------------------------------------------------------
    def all_ids(self) -> List[int]:
        out = []
        for p in self.dir.glob(SNAP_PREFIX + "*"):
            if (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_id(self) -> Optional[int]:
        ids = self.all_ids()
        return ids[-1] if ids else None

    # -- save ----------------------------------------------------------------
    def save(self, state: ServingState, sync: bool = True) -> None:
        """Persist one captured state.  ``sync=False`` writes on a
        background thread (one at a time — a second async save joins the
        first, like the fixed ``CheckpointManager``); the capture is already
        a copy, so the caller may keep mutating immediately."""
        with self._save_lock:
            self.last_capture_s = float(
                state.manifest.get("capture_duration_s", 0.0))
            if self._thread is not None:
                self._thread.join()
                self._thread = None
            if sync:
                self._write(state)
            else:
                self._thread = threading.Thread(
                    target=self._write_guarded, args=(state,),
                    name="serve-snapshot", daemon=True)
                self._thread.start()

    def wait(self, timeout: Optional[float] = None) -> None:
        """Join the background writer; raises ``TimeoutError`` if it is
        still writing after ``timeout`` seconds (None waits for it)."""
        with self._save_lock:
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                raise TimeoutError(
                    f"snapshot writer still running after {timeout:g} s")

    def close(self, timeout: Optional[float] = None) -> None:
        self.wait(timeout)

    def _write_guarded(self, state: ServingState) -> None:
        try:
            self._write(state)
        except BaseException:
            self.failures += 1
            log.exception("background serving snapshot failed")

    def _write(self, state: ServingState) -> None:
        t0 = time.perf_counter()
        ids = self.all_ids()
        snap_id = (ids[-1] + 1) if ids else 1

        def writer(tmp: Path) -> None:
            np.savez(tmp / "arrays.npz", **state.arrays)
            digest = hashlib.sha256(
                (tmp / "arrays.npz").read_bytes()).hexdigest()
            manifest = dict(state.manifest)
            manifest["snap_id"] = snap_id
            manifest["arrays_sha256"] = digest
            (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))

        final = atomic_dir_publish(self.dir, f"{SNAP_PREFIX}{snap_id:010d}",
                                   writer)
        self._gc()
        self._compact_journal()
        self.saved += 1
        self.last_wall_s = time.perf_counter() - t0
        self.last_bytes = sum(
            f.stat().st_size for f in final.iterdir() if f.is_file())
        log.info("serving snapshot %d saved in %.3fs (%d bytes)",
                 snap_id, self.last_wall_s, self.last_bytes)

    def _gc(self) -> None:
        import shutil

        for sid in self.all_ids()[: -self.keep]:
            shutil.rmtree(self.dir / f"{SNAP_PREFIX}{sid:010d}",
                          ignore_errors=True)

    def _compact_journal(self) -> None:
        """Drop WAL records every retained snapshot already covers.  Uses
        the *minimum* retained ``journal_seq`` so corruption fallback to an
        older snapshot still finds its replay tail intact."""
        if self.journal is None:
            return
        seqs = []
        for sid in self.all_ids():
            try:
                m = json.loads(
                    (self.dir / f"{SNAP_PREFIX}{sid:010d}" /
                     "manifest.json").read_text())
                seqs.append(int(m["journal_seq"]))
            except Exception:
                # unreadable manifest: assume it covers nothing (seq 0), so
                # compaction never outruns what fallback could need
                seqs.append(0)
        if seqs:
            self.journal.compact(min(seqs))


def load_serving_snapshot(directory, snap_id: Optional[int] = None
                          ) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """``(manifest, arrays)`` of the newest *readable* snapshot.

    Verifies the manifest's sha256 over ``arrays.npz``; a corrupt or
    unreadable snapshot (fault injection, partial disk failure) is skipped
    with a warning and the next older one is tried — recovery degrades to
    an older state plus a longer journal replay instead of failing.

    The directory is listed again before each attempt, and the newest
    snapshot not yet tried is read: a snapshot that a writer's keep-N
    pruning collected in the middle of the read was replaced by a newer
    one, and that one is read next."""
    directory = Path(directory)
    tried = set()
    last_err: Optional[BaseException] = None
    while True:
        ids = ([int(snap_id)] if snap_id is not None else
               sorted((int(p.name.split("_")[1])
                       for p in directory.glob(SNAP_PREFIX + "*")
                       if (p / "manifest.json").exists()), reverse=True))
        untried = [sid for sid in ids if sid not in tried]
        if not untried:
            break
        sid = untried[0]
        tried.add(sid)
        path = directory / f"{SNAP_PREFIX}{sid:010d}"
        try:
            manifest = json.loads((path / "manifest.json").read_text())
            blob = (path / "arrays.npz").read_bytes()
            digest = hashlib.sha256(blob).hexdigest()
            if digest != manifest.get("arrays_sha256"):
                raise ValueError(
                    f"checksum mismatch in {path.name}/arrays.npz")
            with np.load(io.BytesIO(blob)) as data:
                arrays = {k: data[k].copy() for k in data.files}
            return manifest, arrays
        except BaseException as exc:
            last_err = exc
            log.warning("snapshot %s unreadable (%s); falling back",
                        path.name, exc)
    raise FileNotFoundError(
        f"no readable serving snapshot under {directory}"
        + (f" (last error: {last_err})" if last_err else ""))


# ---------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------


@dataclass
class RestoreResult:
    """Outcome of :func:`restore_serving_state`."""

    ot: Any                       # the reconstructed OnlineTaper
    snap_id: int
    journal_seq: int              # last WAL seq applied (snapshot + replay)
    replayed: int                 # journal batches re-applied
    replay_failed: int            # journal batches dropped (failed live too)
    replay_wall_s: float
    manifest: Dict[str, Any]
    elastic_plan: Optional[Dict[str, Any]] = None


def plan_elastic_restore(g: LabelledGraph, part: np.ndarray,
                         old_shards: int, new_shards: int,
                         block_n: int = 128) -> Dict[str, Any]:
    """Byte-movement budget for restoring onto a different shard count S —
    ``train.elastic.plan_reshard``'s schema over the serving state.  The
    transfer estimate is movement-aware: only vertices whose shard changes
    under the k→S re-fold ship their degree-proportional state."""
    from repro_torch.graphs.sharded_packing import shard_assignment

    old = shard_assignment(part, old_shards, block_n)
    new = shard_assignment(part, new_shards, block_n)
    moved = old != new
    deg = g.degrees
    total_bytes = (g.labels.nbytes + g.src.nbytes + g.dst.nbytes
                   + g.row_ptr.nbytes + np.asarray(part).nbytes)
    # per moved vertex: its CSR adjacency slice (src+dst int32 pairs) plus
    # its fixed row (label, partition id, row_ptr entry)
    est = int(np.sum(deg[moved]) * 8 + int(moved.sum()) * 16)
    plan = movement_plan(total_bytes, old_shards, new_shards, est)
    plan["moved_vertices"] = int(moved.sum())
    plan["moved_frac"] = float(moved.mean()) if moved.size else 0.0
    return plan


def apply_journal_group(ot, members: Sequence[MutationBatch],
                        outcome: Optional[Dict[str, Any]]) -> Tuple[int, int]:
    """Re-apply one journaled coalesced group to an ``OnlineTaper`` exactly
    as the live node applied it; returns ``(applied, failed)`` batch counts.

    This is the one replay fold shared by crash restore
    (:func:`restore_serving_state`) and WAL-shipping replication
    (``serve.replication.FollowerReplica``): a recorded ``"members"``
    outcome (poisoned fold) reproduces the per-member fates verbatim — an
    injected fault is not re-raised by replay, so the ``O`` record, not
    re-execution, is the authority — while a merged outcome (or a missing
    one, crash mid-apply) retraces the deterministic
    try-fold-then-members path."""
    from repro_torch.serve.ingest import coalesce_groups

    applied = failed = 0
    if outcome is not None and outcome.get("mode") == "members":
        for m, ok in zip(members, outcome.get("applied", ())):
            if ok:
                ot.apply_mutations(m)
                applied += 1
            else:
                failed += 1
    else:
        for merged, mem in coalesce_groups(members):
            try:
                ot.apply_mutations(merged)
                applied += 1
            except ValueError:
                for m in mem:
                    try:
                        ot.apply_mutations(m)
                        applied += 1
                    except ValueError:
                        failed += 1
    return applied, failed


def restore_serving_state(
    directory,
    taper_config=None,
    policy=None,
    n_shards: Optional[int] = None,
    snap_id: Optional[int] = None,
    replay: bool = True,
    device=None,
) -> RestoreResult:
    """Rebuild an ``OnlineTaper`` from the latest readable snapshot plus a
    WAL replay (module doc).  ``n_shards`` re-folds the saved shard map onto
    a different S (elastic restore); device packings are *not* rebuilt here
    — callers rewarm via ``ServingLoop._warm_devices`` (or lazily on the
    first field evaluation).  The restored ``OnlineTaper`` evaluates its
    field on ``device`` (default ``"cuda"``; pass ``"cpu"`` on the CPU)."""
    from repro_torch.core.online import OnlineTaper
    from repro_torch.workload.sketch import FrequencySketch

    directory = Path(directory)
    manifest, arrays = load_serving_snapshot(directory, snap_id)
    gm = manifest["graph"]
    g = LabelledGraph(
        n=int(gm["n"]),
        labels=arrays["labels"],
        label_names=list(gm["label_names"]),
        src=arrays["src"],
        dst=arrays["dst"],
        row_ptr=arrays["row_ptr"].astype(np.int64),
        version=int(gm["version"]),
    )
    g._mutation_log = mutation_log_from_state(
        arrays, manifest.get("mutation_log", []))
    ot = OnlineTaper(
        g, int(manifest["k"]),
        part=arrays["part"],
        config=taper_config,
        policy=policy,
        sketch=FrequencySketch.from_state(manifest["sketch"]),
        device=device,
    )
    c = manifest["counters"]
    ot.tick = int(c["tick"])
    ot.invocations = int(c["invocations"])
    ot._last_invoke_tick = int(c["last_invoke_tick"])
    ot._freqs_at_invoke = dict(c["freqs_at_invoke"])
    ot._ipt_at_invoke = (None if c["ipt_at_invoke"] is None
                         else float(c["ipt_at_invoke"]))
    ot._last_total_moves = (None if c["last_total_moves"] is None
                            else int(c["last_total_moves"]))
    ot._dirty = arrays["dirty"].astype(bool).copy()
    rng_state = manifest.get("rng_state")
    if rng_state is not None:
        ot.taper._rng.bit_generator.state = rng_state
    if "placement_pr" in arrays:
        ot.restore_placement_prior(arrays["placement_pr"])

    elastic_plan = None
    saved_shards = manifest.get("n_shards")
    token = manifest.get("shard_order_token")
    if "shard_pos" in arrays:
        pos = arrays["shard_pos"].astype(np.int64)
        if (n_shards is not None and saved_shards
                and int(n_shards) != int(saved_shards)):
            from repro_torch.graphs.sharded_packing import partition_shard_order

            elastic_plan = plan_elastic_restore(
                g, ot.part, int(saved_shards), int(n_shards))
            pos = partition_shard_order(ot.part, int(n_shards))
            token = f"partition:restore{manifest['snap_id']}s{int(n_shards)}"
        ot.taper._pre["_shard_order"] = (token, pos)
    elif (n_shards is not None
          and ot.taper.config.shard_map_source == "partition"):
        from repro_torch.graphs.sharded_packing import partition_shard_order

        ot.taper._pre["_shard_order"] = (
            f"partition:restore{manifest['snap_id']}s{int(n_shards)}",
            partition_shard_order(ot.part, int(n_shards)))

    replayed = replay_failed = 0
    replay_wall = 0.0
    journal_seq = int(manifest["journal_seq"])
    wal = directory / WAL_NAME
    if replay and wal.exists():
        t0 = time.perf_counter()
        for seq, members, outcome in MutationJournal(wal).replay(
                after_seq=journal_seq):
            ok, bad = apply_journal_group(ot, members, outcome)
            replayed += ok
            replay_failed += bad
            journal_seq = seq
        replay_wall = time.perf_counter() - t0
    log.info(
        "restored serving state: snapshot %d (graph v%d, n=%d), replayed "
        "%d journal batches (%d dropped) in %.3fs",
        manifest["snap_id"], g.version, g.n, replayed, replay_failed,
        replay_wall)
    return RestoreResult(
        ot=ot,
        snap_id=int(manifest["snap_id"]),
        journal_seq=journal_seq,
        replayed=replayed,
        replay_failed=replay_failed,
        replay_wall_s=replay_wall,
        manifest=manifest,
        elastic_plan=elastic_plan,
    )
