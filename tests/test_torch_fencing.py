"""Epoch fencing and durable-write integrity on the port against the JAX
package's.

Twins of ``tests/test_fencing.py``: the partitioned zombie's
post-failover invocation commit and snapshot publish are rejected with a
stale epoch (seen in ``stats()``), the fence primitive itself, torn-tail
WAL truncation at every byte offset of the final frame, and the snapshot
manifest's wall-time / capture-duration split.  The cluster scenarios run
through both packages (the port with ``device="cpu"``) and what they
observe must be equal; the torn-tail sweep runs on the port's journal,
whose bytes are first held to the reference's."""
import json
import time

import pytest

from test_torch_replication import (  # same-directory sibling
    PORT, REF, _both, _cluster, _policy, _state)


# ---------------------------------------------------------------------------
# zombie fencing
# ---------------------------------------------------------------------------


def _zombie(P, tmp):
    coord = _cluster(P, tmp, n_followers=1, heartbeat_timeout_s=0.05)
    for i in range(8):
        coord.serve([P.MQ3], cls="hot")
        coord.submit_mutations(P.MutationBatch(add_edges=[(i % 7, (3 * i) % 11)]))
        coord.pump()
    old = coord.primary
    coord.partition_primary()
    time.sleep(0.06)
    coord.pump()
    assert coord.primary is not old
    assert coord.stats()["cluster_epoch"] == 2

    # the zombie serves its own request stream: the only durable writes it
    # will attempt are invocation commits (requests only, no mutations)
    before = old.stats()
    for _ in range(14):
        old.submit(P.MQ3)
        old.pump()
    zst = old.stats()
    assert zst["fenced_writes"] > before["fenced_writes"]
    assert zst["invocation_failures"] == before["invocation_failures"]
    assert zst["invocations"] == before["invocations"]  # commit never ran
    assert zst["epoch"] == 1 and zst["cluster_epoch"] == 2
    assert zst["fenced"] == 1
    assert zst["last_stale_epoch"] == 1
    assert "stale epoch 1" in zst["fence_error"]

    # the zombie's snapshot publish is fenced the same way
    fw0, sf0 = zst["fenced_writes"], zst["snapshot_failures"]
    old.snapshot(sync=True)
    zst2 = old.stats()
    assert zst2["fenced_writes"] == fw0 + 1
    assert zst2["snapshot_failures"] == sf0 + 1

    # cluster-side accounting saw the rejections too
    cst = coord.stats()
    assert cst["fencing_rejections"] > 0
    assert cst["last_stale_epoch"] == 1
    assert cst["stale_heartbeats"] > 0
    keys = ("fenced_writes", "invocation_failures", "invocations", "epoch",
            "cluster_epoch", "fenced", "last_stale_epoch", "fence_error",
            "snapshot_failures")
    out = {"zombie": {k: zst2[k] for k in keys}, "hub": coord.hub.stats(),
           "zombie_state": _state(old.ot), "promoted": _state(coord.primary.ot),
           "promoted_slot": coord.primary_slot}
    coord.stop()
    return out


def test_zombie_commit_and_snapshot_fenced_with_stale_epoch(tmp_path):
    """After a partition-driven failover the deposed primary keeps
    running; its commit and snapshot publish carry epoch 1 against a
    cluster at epoch 2 and are fenced, not charged as invocation failures."""
    _both(_zombie, tmp_path)


def _authorize(P, tmp):
    coord = _cluster(P, tmp, n_followers=1, heartbeat_timeout_s=0.05)
    hub = coord.hub
    hub.partition_primary(True)
    with pytest.raises(P.replication.FencedWrite) as e1:
        hub.authorize(1, "ingest group")
    assert e1.value.partitioned and e1.value.what == "ingest group"
    hub.partition_primary(False)
    hub.advance_epoch()
    with pytest.raises(P.replication.FencedWrite) as e2:
        hub.authorize(1, "snapshot publish")
    assert not e2.value.partitioned
    assert e2.value.stale_epoch == 1 and e2.value.current_epoch == 2
    out = {"errors": [str(e1.value), str(e2.value)], "hub": hub.stats()}
    coord.stop()
    return out


def test_authorize_raises_fenced_write(tmp_path):
    """Stale epoch and lapsed (partitioned) lease are told apart on the
    raised error, with the reference's messages."""
    _both(_authorize, tmp_path)


# ---------------------------------------------------------------------------
# WAL torn tails
# ---------------------------------------------------------------------------


def _journal(P, path):
    """A 3-record journal; returns its sizes after records 2 and 3."""
    MB = P.MutationBatch
    j = P.snapshot.MutationJournal(path)
    s1 = j.append_group([MB(add_edges=[(0, 1)])])
    j.append_outcome(s1, "merged", [True])
    size2 = path.stat().st_size
    j.append_group([MB(add_vertex_labels=[1], add_edges=[(1, 2)]),
                    MB(add_edges=[(2, 3)])])
    size3 = path.stat().st_size
    j.close()
    return size2, size3


def test_torn_tail_truncation_at_every_offset(tmp_path):
    """Kill the writer mid-frame at every byte offset of the final frame of
    a 3-record journal: reopening recovers the intact prefix, truncates the
    torn bytes and stays appendable.  The journal is the reference's byte
    for byte, so the sweep runs on the port's reader alone."""
    (tmp_path / "ref").mkdir()
    sizes_ref = _journal(REF, tmp_path / "ref" / "wal.log")
    src = tmp_path / "wal.log"
    size2, size3 = _journal(PORT, src)
    blob = src.read_bytes()
    assert (size2, size3) == sizes_ref
    assert blob == (tmp_path / "ref" / "wal.log").read_bytes()
    assert size3 > size2 + 16  # the final frame spans many offsets
    MJ = PORT.snapshot.MutationJournal
    for off in range(size2, size3):
        d = tmp_path / f"torn_{off}"
        d.mkdir()
        p = d / "wal.log"
        p.write_bytes(blob[:off])
        jj = MJ(p)
        assert p.stat().st_size == size2  # torn bytes gone
        groups = jj.replay()
        assert [g[0] for g in groups] == [1]
        _, members, outcome = groups[0]
        assert len(members) == 1
        assert outcome == {"mode": "merged", "applied": [True]}
        # appends after recovery continue the sequence and stay readable
        assert jj.append_group([PORT.MutationBatch(add_edges=[(4, 5)])]) == 2
        jj.close()
        assert [g[0] for g in MJ(p).replay()] == [1, 2]


# ---------------------------------------------------------------------------
# snapshot manifest timing (wall time vs capture duration)
# ---------------------------------------------------------------------------


def _manifest(P, tmp):
    tmp.mkdir(parents=True)
    g = P.gen.musicbrainz_like(300, seed=3)
    cfg = P.serve.ServeLoopConfig(micro_batch=8, overlap_invocations=False,
                                  snapshot_dir=str(tmp))
    loop = P.serve.ServingLoop(g, 4, taper_config=P.taper.TaperConfig(max_iterations=2),
                               policy=_policy(P), config=cfg, **P.loop_kw)
    loop.snapshot(sync=True)
    snaps = sorted(tmp.glob("snap_*"))
    man = json.loads((snaps[-1] / "manifest.json").read_text())
    now = time.time()
    # wall clock: epoch seconds, not a small monotonic-counter value
    assert man["time"] > 1e9 and abs(man["time"] - now) < 300
    assert abs(man["wall_time_s"] - man["time"]) < 5.0
    assert 0 < man["capture_duration_s"] < 60
    st = loop.stats()
    assert st["snapshot_capture_s"] == man["capture_duration_s"]
    assert st["snapshot_publish_s"] > 0
    assert st["snapshots_taken"] >= 1
    loop.stop()
    return {"keys": sorted(man), "snapshots": [p.name for p in snaps],
            "taken": st["snapshots_taken"]}


def test_snapshot_manifest_wall_time_and_capture_duration(tmp_path):
    """The manifest's ``time`` is wall-clock, the capture cost is measured
    on the monotonic clock, and both halves surface in ``stats()``."""
    _both(_manifest, tmp_path)
