"""Crash-safe serving on the port against the JAX package's: WAL framing
and torn tails, atomic snapshots with corruption fallback, kill-and-restore
parity, elastic restore onto another shard count, sketch persistence.

Twins of ``tests/test_recovery.py``, plus files that cross packages: the
port's WAL is byte for byte the reference's for the same groups and
outcomes, and a snapshot plus WAL written by either package restores into
the other bitwise.  Kill-and-restore parity holds at each cut of a mixed
request and mutation stream, against the port's uninterrupted loop and the
reference's."""
import json

import numpy as np
import pytest

from repro.core.online import OnlinePolicy as ROnlinePolicy
from repro.core.rpq import parse_rpq as r_parse
from repro.core.taper import TaperConfig as RTaperConfig
from repro.graphs import generators as RG
from repro.graphs.graph import MutationBatch as RMutationBatch
from repro.serve import ServeLoopConfig as RServeLoopConfig
from repro.serve import ServingLoop as RServingLoop
from repro.serve.snapshot import MutationJournal as RMutationJournal
from repro_torch.core.online import OnlinePolicy
from repro_torch.core.rpq import parse_rpq
from repro_torch.core.taper import TaperConfig
from repro_torch.graphs import generators as PG
from repro_torch.graphs.graph import MutationBatch
from repro_torch.graphs.sharded_packing import partition_shard_order, shard_assignment
from repro_torch.serve import ServeLoopConfig, ServingLoop
from repro_torch.serve.faults import corrupt_latest_snapshot
from repro_torch.serve.snapshot import (MutationJournal, ServingSnapshotter,
                                        capture_serving_state, load_serving_snapshot,
                                        plan_elastic_restore, restore_serving_state)
from repro_torch.workload.sketch import FrequencySketch

MQ_TEXT = ("Area.Artist.(Artist|Label).Area", "Artist.Credit.Track.Medium")
MQ1, MQ3 = (parse_rpq(t) for t in MQ_TEXT)
R_MQ1, R_MQ3 = (r_parse(t) for t in MQ_TEXT)
#: manifest fields that differ between two writes of one state: clocks, and
#: the rung's name (the port's "torch" is the reference's "jnp")
VOLATILE = {"time", "wall_time_s", "capture_duration_s", "field_backend"}


def _policy(pkg=OnlinePolicy):
    return pkg(bootstrap_after_ticks=0, cadence=6, min_interval=0, dirty_fraction=0.02,
               drift_l1=9e9, ipt_regression=9e9)


def _loop(g, tmp=None, **cfg_kw):
    return ServingLoop(g, 4, taper_config=TaperConfig(max_iterations=2), policy=_policy(),
                       config=ServeLoopConfig(micro_batch=8, overlap_invocations=False,
                                              snapshot_dir=None if tmp is None else str(tmp),
                                              **cfg_kw),
                       device="cpu")


def _rloop(g, tmp=None):
    return RServingLoop(g, 4, taper_config=RTaperConfig(max_iterations=2),
                        policy=_policy(ROnlinePolicy),
                        config=RServeLoopConfig(micro_batch=8, overlap_invocations=False,
                                                snapshot_dir=None if tmp is None else str(tmp)))


def _restore(tmp, **kw):
    return ServingLoop.restore(tmp, taper_config=TaperConfig(max_iterations=2),
                               policy=_policy(),
                               config=ServeLoopConfig(micro_batch=8, overlap_invocations=False),
                               device="cpu", **kw)


def _rrestore(tmp):
    return RServingLoop.restore(tmp, taper_config=RTaperConfig(max_iterations=2),
                                policy=_policy(ROnlinePolicy),
                                config=RServeLoopConfig(micro_batch=8,
                                                        overlap_invocations=False))


def _stream(n0, steps=30, seed=0, batch=MutationBatch, q1=MQ1, q3=MQ3):
    """The reference test's deterministic mixed request + mutation stream."""
    rng = np.random.default_rng(seed)
    ops, n = [], n0
    for i in range(steps):
        ops.append(("req", q1 if i % 3 else q3))
        r = rng.random()
        if r < 0.3:
            ops.append(("mut", batch(add_vertex_labels=[int(rng.integers(0, 4))],
                                     add_edges=[(int(rng.integers(0, n)), n)])))
            n += 1
        elif r < 0.5:
            ops.append(("mut", batch(add_edges=[(int(rng.integers(0, n0)),
                                                 int(rng.integers(0, n0)))])))
        ops.append(("pump",))
    return ops


def _rstream(n0, steps=30, seed=0):
    return _stream(n0, steps, seed, RMutationBatch, R_MQ1, R_MQ3)


def _drive(loop, ops):
    for op in ops:
        if op[0] == "req":
            loop.submit(op[1])
        elif op[0] == "mut":
            assert loop.submit_mutations(op[1]) is True
        else:
            loop.pump()


def _assert_durable_parity(a, b, queries=((MQ1, MQ1), (MQ3, MQ3))):
    """Bitwise equality of everything snapshot + WAL replay guarantees at an
    arbitrary kill point (``a`` and ``b`` may be loops of either package;
    ``queries`` pairs each query in ``a``'s package with ``b``'s)."""
    assert a.g.n == b.g.n and a.g.version == b.g.version
    for x, y in [(a.g.labels, b.g.labels), (a.g.src, b.g.src), (a.g.dst, b.g.dst),
                 (a.g.row_ptr, b.g.row_ptr), (a.part, b.part), (a.ot._dirty, b.ot._dirty)]:
        assert x.dtype == y.dtype and np.array_equal(x, y)
    la, lb = a.g.mutation_log, b.g.mutation_log
    assert len(la) == len(lb)
    for ra, rb in zip(la, lb):
        assert (ra.version, ra.version_base, ra.n_before, ra.n_after) == \
            (rb.version, rb.version_base, rb.n_before, rb.n_after)
        assert np.array_equal(ra.added_src, rb.added_src)
        assert np.array_equal(ra.old2new, rb.old2new)
    assert a.ot.invocations == b.ot.invocations
    assert a.ot._freqs_at_invoke == b.ot._freqs_at_invoke
    assert a.ot.taper._rng.bit_generator.state == b.ot.taper._rng.bit_generator.state
    for qa, qb in queries:
        assert a.executor.enumerate_paths(qa, max_results=16, part=a.part) == \
            b.executor.enumerate_paths(qb, max_results=16, part=b.part)
    cnt_a, cnt_b = a.g.cached_neighbor_label_counts(), b.g.cached_neighbor_label_counts()
    assert np.array_equal(cnt_a, cnt_b)
    order_a, order_b = partition_shard_order(a.part, 2), partition_shard_order(b.part, 2)
    assert np.array_equal(order_a, order_b)
    pa = a.g.vm_packing_sharded(2, cnt=cnt_a, order=order_a, order_token="t")
    pb = b.g.vm_packing_sharded(2, cnt=cnt_b, order=order_b, order_token="t")
    for fa, fb in [(pa.pos_of, pb.pos_of), (pa.src_global, pb.src_global),
                   (pa.dst_global, pb.dst_global), (pa.meta, pb.meta)]:
        assert np.array_equal(fa, fb)


def _assert_full_parity(a, b, **kw):
    _assert_durable_parity(a, b, **kw)
    assert a.ot.tick == b.ot.tick
    assert a.ot.sketch.counts == b.ot.sketch.counts
    assert a.ot.sketch._stamp == b.ot.sketch._stamp
    assert a.ot.sketch._ticks == b.ot.sketch._ticks


CROSS = ((MQ1, R_MQ1), (MQ3, R_MQ3))


# ---------------------------------------------------------------------------
# WAL framing
# ---------------------------------------------------------------------------


def _journal_ops(journal_cls, batch, path):
    j = journal_cls(path)
    s1 = j.append_group([batch(add_edges=[(0, 1)]),
                         batch(add_vertex_labels=[2], add_edges=[(3, 10)])])
    j.append_outcome(s1, "merged", [True, True])
    s2 = j.append_group([batch(remove_vertices=[5], relabel=[(1, 3)])])
    j.append_outcome(s2, "members", [True])
    j.close()
    if hasattr(j, "appended_bytes"):   # the port counts what it appended
        assert j.appended == 4 and j.appended_bytes == path.stat().st_size
    return (s1, s2), path.read_bytes()


def test_journal_group_roundtrip_and_outcomes(tmp_path):
    seqs, wal = _journal_ops(MutationJournal, MutationBatch, tmp_path / "wal.log")
    assert seqs == (1, 2)
    # byte for byte the reference's WAL of the same groups and outcomes
    assert wal == _journal_ops(RMutationJournal, RMutationBatch, tmp_path / "r.log")[1]
    j = MutationJournal(tmp_path / "wal.log")
    out = j.replay()
    assert [seq for seq, _, _ in out] == [1, 2]
    seq, members, outcome = out[0]
    assert len(members) == 2
    assert np.array_equal(members[0].add_edges, [[0, 1]])
    assert np.array_equal(members[1].add_vertex_labels, [2])
    assert outcome == {"mode": "merged", "applied": [True, True]}
    assert out[1][2]["mode"] == "members"
    assert [seq for seq, _, _ in j.replay(after_seq=1)] == [2]
    j.close()
    j2 = MutationJournal(tmp_path / "wal.log")
    assert j2.last_seq == 2 and len(j2.replay()) == 2
    # each package replays the other's journal to the same groups
    r_out = RMutationJournal(tmp_path / "wal.log").replay()
    for (s, m, o), (rs, rm, ro) in zip(out, r_out):
        assert s == rs and o == ro and len(m) == len(rm)
        for b, rb in zip(m, rm):
            for f in ("add_vertex_labels", "add_edges", "remove_edges", "remove_vertices",
                      "relabel"):
                assert np.array_equal(getattr(b, f), getattr(rb, f))


def test_journal_torn_tail_is_truncated_and_replay_survives(tmp_path):
    path = tmp_path / "wal.log"
    j = MutationJournal(path)
    j.append_group([MutationBatch(add_edges=[(0, 1)])])
    j.append_group([MutationBatch(add_edges=[(1, 2)])])
    j.close()
    size = path.stat().st_size
    with open(path, "r+b") as fh:
        fh.truncate(size - 7)
    torn = path.read_bytes()
    j2 = MutationJournal(path)
    assert path.stat().st_size < size - 7 or j2.last_seq == 1
    assert [seq for seq, _, _ in j2.replay()] == [1]
    j2.append_group([MutationBatch(add_edges=[(2, 3)])])
    assert [seq for seq, _, _ in j2.replay()] == [1, 2]
    # the reference truncates the same torn file to the same bytes
    for name, journal_cls in (("p.log", MutationJournal), ("r.log", RMutationJournal)):
        (tmp_path / name).write_bytes(torn)
        journal_cls(tmp_path / name)
    assert (tmp_path / "p.log").read_bytes() == (tmp_path / "r.log").read_bytes()


def test_journal_compaction_drops_covered_groups(tmp_path):
    walls = []
    for journal_cls, batch, name in ((MutationJournal, MutationBatch, "p.log"),
                                     (RMutationJournal, RMutationBatch, "r.log")):
        j = journal_cls(tmp_path / name)
        for i in range(4):
            s = j.append_group([batch(add_edges=[(i, i + 1)])])
            j.append_outcome(s, "merged", [True])
        assert j.compact(2) == 4
        assert [seq for seq, _, _ in j.replay()] == [3, 4] and j.last_seq == 4
        assert j.append_group([batch(add_edges=[(9, 10)])]) == 5
        j.close()
        walls.append((tmp_path / name).read_bytes())
    assert walls[0] == walls[1]


# ---------------------------------------------------------------------------
# snapshotter
# ---------------------------------------------------------------------------


def test_snapshotter_keep_n_and_async_serialization(tmp_path):
    g = PG.musicbrainz_like(300, seed=1)
    loop = _loop(g)
    snap = ServingSnapshotter(tmp_path, keep=2)
    for _ in range(4):
        snap.save(capture_serving_state(loop.ot, 0), sync=False)
    snap.close()
    assert snap.saved == 4 and snap.failures == 0 and snap.all_ids() == [3, 4]
    manifest, arrays = load_serving_snapshot(tmp_path)
    assert manifest["snap_id"] == 4 and arrays["part"].shape == (g.n,)
    loop.stop()


def test_corrupt_snapshot_falls_back_to_older(tmp_path):
    g = PG.musicbrainz_like(300, seed=2)
    loop = _loop(g)
    snap = ServingSnapshotter(tmp_path, keep=3)
    snap.save(capture_serving_state(loop.ot, 0))
    g.apply_mutations(MutationBatch(add_edges=[(0, 5)]))
    snap.save(capture_serving_state(loop.ot, 1))
    corrupt_latest_snapshot(tmp_path)
    manifest, _ = load_serving_snapshot(tmp_path)
    assert manifest["snap_id"] == 1 and manifest["journal_seq"] == 0
    with pytest.raises(FileNotFoundError):
        load_serving_snapshot(tmp_path, snap_id=2)
    loop.stop()


def test_snapshot_arrays_and_manifest_equal_the_reference(tmp_path):
    """One stream through both packages' loops: each snapshot's arrays bit
    for bit, and each manifest key for key but the clocks and the rung."""
    ops, r_ops = _stream(400, steps=25, seed=3), _rstream(400, steps=25, seed=3)
    loop = _loop(PG.musicbrainz_like(400, seed=7), tmp=tmp_path / "p")
    ref = _rloop(RG.musicbrainz_like(400, seed=7), tmp=tmp_path / "r")
    _drive(loop, ops)
    _drive(ref, r_ops)
    loop.snapshot(sync=True)
    ref.snapshot(sync=True)
    assert loop._snapshotter.all_ids() == ref._snapshotter.all_ids()
    for sid in loop._snapshotter.all_ids():
        m, a = load_serving_snapshot(tmp_path / "p", snap_id=sid)
        rm, ra = load_serving_snapshot(tmp_path / "r", snap_id=sid)
        assert sorted(a) == sorted(ra)
        for k in a:
            assert a[k].dtype == ra[k].dtype and np.array_equal(a[k], ra[k]), k
        assert m["field_backend"] == "torch" and rm["field_backend"] == "jnp"
        # arrays_sha256 included: the two arrays.npz files are byte for byte
        assert {k: v for k, v in m.items() if k not in VOLATILE} == \
            {k: v for k, v in rm.items() if k not in VOLATILE}
    assert (tmp_path / "p" / "wal.log").read_bytes() == (tmp_path / "r" / "wal.log").read_bytes()
    loop.stop()
    ref.stop()


# ---------------------------------------------------------------------------
# kill-and-restore parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cut", [17, 41])
def test_kill_and_restore_bitwise_parity(tmp_path, cut):
    g = PG.musicbrainz_like(400, seed=7)
    ops = _stream(g.n, steps=25, seed=3)
    crash = _loop(g, tmp=tmp_path)
    crash.snapshot(sync=True)
    _drive(crash, ops[:cut])
    crash._snapshotter.wait()
    restored = _restore(tmp_path)
    _assert_durable_parity(restored, crash)
    assert restored.restore_result.replay_failed == 0
    assert restored.stats()["journal_seq"] == crash.stats()["journal_seq"]
    # the reference restores the same cut to the same state
    rg = RG.musicbrainz_like(400, seed=7)
    r_crash = _rloop(rg, tmp=tmp_path / "ref")
    r_crash.snapshot(sync=True)
    _drive(r_crash, _rstream(rg.n, steps=25, seed=3)[:cut])
    r_crash._snapshotter.wait()
    _assert_durable_parity(restored, _rrestore(tmp_path / "ref"), queries=CROSS)


@pytest.mark.parametrize("cut", [9, 23, 33])
def test_kill_and_restore_across_packages(tmp_path, cut):
    """A snapshot + WAL written by either package restores into the other,
    bitwise the crashed loop."""
    g, rg = PG.musicbrainz_like(400, seed=7), RG.musicbrainz_like(400, seed=7)
    crash, r_crash = _loop(g, tmp=tmp_path / "p"), _rloop(rg, tmp=tmp_path / "r")
    crash.snapshot(sync=True)
    r_crash.snapshot(sync=True)
    _drive(crash, _stream(g.n, steps=25, seed=3)[:cut])
    _drive(r_crash, _rstream(rg.n, steps=25, seed=3)[:cut])
    crash._snapshotter.wait()
    r_crash._snapshotter.wait()
    assert (tmp_path / "p" / "wal.log").read_bytes() == (tmp_path / "r" / "wal.log").read_bytes()
    from_ref = _restore(tmp_path / "r")          # the reference's files, the port
    from_port = _rrestore(tmp_path / "p")        # the port's files, the reference
    _assert_durable_parity(from_ref, r_crash, queries=CROSS)
    _assert_durable_parity(crash, from_port, queries=CROSS)
    _assert_durable_parity(from_ref, crash)


def test_kill_on_snapshot_full_parity_and_continuation(tmp_path):
    g_ref = PG.musicbrainz_like(400, seed=7)
    g_crash = g_ref.copy()
    ops = _stream(g_ref.n, steps=25, seed=3)
    cut = [i + 1 for i, op in enumerate(ops) if op[0] == "pump"][10]
    ref = _loop(g_ref)
    _drive(ref, ops)
    crash = _loop(g_crash, tmp=tmp_path)
    _drive(crash, ops[:cut])
    crash.snapshot(sync=True)
    crash._snapshotter.wait()
    restored = _restore(tmp_path)
    _assert_full_parity(restored, crash)
    _drive(restored, ops[cut:])
    _assert_full_parity(restored, ref)
    # and the reference's uninterrupted loop over the same stream
    r_ref = _rloop(RG.musicbrainz_like(400, seed=7))
    _drive(r_ref, _rstream(400, steps=25, seed=3))
    _assert_full_parity(restored, r_ref, queries=CROSS)


def test_restore_after_corruption_replays_longer_tail(tmp_path):
    g = PG.musicbrainz_like(400, seed=9)
    live = _loop(g, tmp=tmp_path)
    live.snapshot(sync=True)
    _drive(live, _stream(g.n, steps=20, seed=5))
    live.snapshot(sync=True)
    newest = live._snapshotter.latest_id()
    corrupt_latest_snapshot(tmp_path)
    restored = _restore(tmp_path)
    assert restored.restore_result.snap_id < newest
    _assert_durable_parity(restored, live)


# ---------------------------------------------------------------------------
# elastic restore
# ---------------------------------------------------------------------------


def test_elastic_restore_onto_different_shard_count(tmp_path):
    g = PG.musicbrainz_like(1200, seed=11)
    loop = ServingLoop(
        g, 4, taper_config=TaperConfig(max_iterations=2, field_backend="torch_sharded",
                                       shard_map_source="partition"),
        policy=_policy(),
        config=ServeLoopConfig(micro_batch=8, overlap_invocations=False,
                               snapshot_dir=str(tmp_path)),
        device="cpu")
    for _ in range(10):
        loop.submit(MQ1)
        loop.pump()
    assert loop.ot.invocations >= 1 and "_shard_order" in loop.ot.taper._pre
    loop.snapshot(sync=True)
    live_part = loop.part.copy()
    live_shards = loop.ot.taper._group_shards()
    new_s = 3 if live_shards == 4 else 4
    res = restore_serving_state(
        tmp_path, n_shards=new_s, device="cpu",
        taper_config=TaperConfig(max_iterations=2, field_backend="torch",
                                 shard_map_source="partition"))
    token, pos = res.ot.taper._pre["_shard_order"]
    assert "restore" in token and np.array_equal(pos, partition_shard_order(live_part, new_s))
    plan = res.elastic_plan
    assert plan is not None
    assert plan["old_chips"] == live_shards and plan["new_chips"] == new_s
    assert plan["total_state_bytes"] > 0
    assert 0 < plan["est_transfer_bytes"] <= plan["total_state_bytes"]
    assert 0.0 < plan["moved_frac"] <= 1.0
    cnt = res.ot.g.cached_neighbor_label_counts()
    restored_sp = res.ot.g.vm_packing_sharded(new_s, cnt=cnt, order=pos, order_token=token)
    scratch_sp = g.vm_packing_sharded(new_s, cnt=g.cached_neighbor_label_counts(),
                                      order=partition_shard_order(live_part, new_s),
                                      order_token="scratch")
    for fa, fb in [(restored_sp.pos_of, scratch_sp.pos_of),
                   (restored_sp.src_global, scratch_sp.src_global),
                   (restored_sp.dst_global, scratch_sp.dst_global),
                   (restored_sp.meta, scratch_sp.meta)]:
        assert np.array_equal(fa, fb)
    # the reference's plan of the same move
    from repro.serve.snapshot import plan_elastic_restore as r_plan
    rg = RG.musicbrainz_like(1200, seed=11)
    assert r_plan(rg, live_part, live_shards, new_s) == \
        plan_elastic_restore(g, live_part, live_shards, new_s)
    loop.stop()


def test_plan_elastic_restore_counts_moved_state():
    from repro.graphs.sharded_packing import shard_assignment as r_assign
    from repro.serve.snapshot import plan_elastic_restore as r_plan

    g, rg = PG.musicbrainz_like(400, seed=13), RG.musicbrainz_like(400, seed=13)
    part = np.arange(g.n, dtype=np.int32) % 4
    plan = plan_elastic_restore(g, part, old_shards=2, new_shards=4)
    moved = shard_assignment(part, 2) != shard_assignment(part, 4)
    assert plan["moved_vertices"] == int(moved.sum())
    assert plan["bytes_per_new_chip"] * 4 >= plan["total_state_bytes"]
    same = plan_elastic_restore(g, part, old_shards=2, new_shards=2)
    assert same["moved_vertices"] == 0 and same["est_transfer_bytes"] == 0
    assert plan == r_plan(rg, part, 2, 4) and same == r_plan(rg, part, 2, 2)
    for s in (1, 2, 3, 5):
        assert np.array_equal(shard_assignment(part, s), r_assign(part, s))


# ---------------------------------------------------------------------------
# sketch persistence
# ---------------------------------------------------------------------------


def test_sketch_state_roundtrip_preserves_decay_clock():
    from repro.workload.sketch import FrequencySketch as RFrequencySketch

    sk = FrequencySketch(half_life=8.0)
    for i in range(6):
        sk.observe_batch([MQ1] * 3 + [MQ3] * (i % 2))
    state = sk.state_dict()
    back = FrequencySketch.from_state(state)
    assert back._ticks == sk._ticks and back.counts == sk.counts
    assert back._stamp == sk._stamp and back.frequencies() == sk.frequencies()
    for qh, q in back.queries.items():
        assert q.qhash == qh
    assert {q.qhash for q, _ in back.workload()} == {q.qhash for q, _ in sk.workload()}
    # the state crosses packages through JSON, as a manifest carries it
    r_back = RFrequencySketch.from_state(json.loads(json.dumps(state)))
    assert r_back.counts == sk.counts and r_back.frequencies() == sk.frequencies()
