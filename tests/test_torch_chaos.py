"""Chaos-soak scenarios on the port against the JAX package's.

Twins of ``tests/test_chaos.py``: the four canonical storms (crash storm,
slow follower, flash crowd, partition heal) on a virtual clock, checked
for the robustness invariants and bit-reproducibility, the seed actually
reaching the digest, the flight recorder's evidence, and the harness's
refusals.  Each scenario also runs through the reference in the same test:
its report — digest, counters, fired faults — must be the port's, and the
digest must be the constant pinned below (SHA-256 over graph arrays,
partition, dirty bits, RNG state, counters and probe answers, the same
under any string-hash seed)."""
import functools

import numpy as np
import pytest

from test_torch_replication import PORT, REF, _canon, _late_snapshots, _sync_snapshots

#: each canonical scenario's digest, from the JAX package's run
DIGESTS = {
    "crash_storm": "4758df45327b1c4f1551edd36bf76eb4ff4d0ea131e77f421f1aa90c1f14a717",
    "flash_crowd": "eeef98ee14101be81ba16b68e496dccfc7ae2667d4e29eb5408f1463bfdc1f83",
    "partition_heal": "3089839046207db048371c5dd27287e10f10d4cfae832f76e6eaad5da01f95e7",
    "slow_follower": "e5a263a7918521e9a663f23d0d21bfaf684e2f87065982e694c3077f398a1dcb",
}

#: report stats fields that hold clock readings, count reads hedged on a
#: wall-clock deadline, or name the field's rung (the port's "torch" is
#: the reference's "jnp")
_VOLATILE = ("latency", "_s", "wall", "hedge", "field_backend", "qps", "rate",
             "pressure", "utilization", "age")


def _run(P, tmp_path, name, sub="a"):
    d = tmp_path / P.root / sub
    d.mkdir(parents=True, exist_ok=True)
    return P.chaos.ChaosHarness(d, P.chaos.scenario(name), **P.loop_kw).run()


def _assert_green(r):
    assert r.invariant_errors == []
    assert r.staleness_violations == []
    assert r.ok


def _report(r):
    """A report's deterministic content."""
    stats = {k: v for k, v in r.stats.items()
             if not any(w in k for w in _VOLATILE) and not isinstance(v, dict)}
    return _canon({"digest": r.digest, "watermark": r.watermark_seq, "final": r.final_seq,
                   "failovers": r.failovers, "rejoins": r.rejoins, "epoch": r.epoch,
                   "shed_raises": r.shed_raises, "breaker_trips": r.breaker_trips,
                   "faults": r.faults_fired, "stats": stats})


def _journal_span(hub):
    """The hub's journal's first and last seq (None without a journal)."""
    if hub.journal is None:
        return None
    groups = hub.journal.replay(after_seq=0)
    return (groups[0][0] if groups else None, int(hub.journal.last_seq))


def _record_rejoins(monkeypatch, P):
    """Notes of each follower re-bootstrap of package ``P``, taken by
    wrappers that call the originals: the replica, the snapshot restored
    (its id, its ``journal_seq``, the journal batches the restore itself
    replayed), the journal's first and last seq when the tail is read, and
    the frames ``hub.tail`` returned or the ``JournalGap`` it raised."""
    notes = []
    rep_cls, gap = P.replication.FollowerReplica, P.replication.JournalGap
    restore = P.replication.restore_serving_state

    def noted_restore(*args, **kw):
        res = restore(*args, **kw)
        if notes and "_hub" in notes[-1] and "snapshot" not in notes[-1]:
            notes[-1]["snapshot"] = (res.snap_id, int(res.manifest["journal_seq"]),
                                     res.replayed)
        return res

    def noted_tail(hub_tail, note, after_seq, after_commit_index):
        note["tail_from"] = (int(after_seq), int(after_commit_index))
        note["journal_at_tail"] = _journal_span(note["_hub"])
        try:
            frames = hub_tail(after_seq, after_commit_index)
        except gap:
            note["journal_gap"] = True
            raise
        note["frames"] = [f.kind for f in frames]
        return frames

    rebootstrap = rep_cls._rebootstrap

    def noted_rebootstrap(self):
        note = {"replica": self.name, "applied_seq_before": self.applied_seq,
                "journal_at_start": _journal_span(self.hub), "_hub": self.hub}
        notes.append(note)
        self.hub.tail = functools.partial(noted_tail, type(self.hub).tail.__get__(self.hub),
                                          note)
        try:
            rebootstrap(self)
        finally:
            del self.hub.tail
            note.pop("_hub", None)
        note["applied_seq_after"] = self.applied_seq

    monkeypatch.setattr(P.replication, "restore_serving_state", noted_restore)
    monkeypatch.setattr(rep_cls, "_rebootstrap", noted_rebootstrap)
    if hasattr(rep_cls, "_replay_tail"):       # the port's tail after its restore
        replay_tail = rep_cls._replay_tail

        def noted_replay_tail(self):
            if notes and "_hub" in notes[-1]:
                notes[-1]["replay_from"] = self.applied_seq
            return replay_tail(self)

        monkeypatch.setattr(rep_cls, "_replay_tail", noted_replay_tail)
    return notes


def _owners_by_identity(self):
    """The port's ``ClusterRouter.owners``: the owner map cached against
    the partition vector itself, not its ``id``."""
    part = self.coord.primary.ot.part
    if getattr(self, "_owner_part", None) is not part:
        self._owner_of = REF.cluster.shard_assignment(
            part, self.coord.n_replicas, block_n=self.coord.cfg.block_n)
        self._owner_part = part
    return self._owner_of


def _pin_owner_cache(monkeypatch):
    """The reference's router keyed its owner map by ``id(part)``: a
    partition vector rebound at the freed one's address (CPython reuses
    them; when, follows the allocations of the background snapshot writer)
    kept the old owners, and its ``cross_replica_ipt`` parted from the
    port's (411 against 425 in the crash storm).  Pinned to the port's
    identity cache, as the snapshot writers are pinned elsewhere."""
    monkeypatch.setattr(REF.cluster.ClusterRouter, "owners", _owners_by_identity)


def _run_both(tmp_path, name, monkeypatch):
    """The port's report, after holding it to the reference's (its owner
    cache pinned, :func:`_pin_owner_cache`) and its digest to the pinned
    constant.  Each package's follower re-bootstraps are noted
    (:func:`_record_rejoins`) and printed, with the stats that differ,
    when the reports differ."""
    _pin_owner_cache(monkeypatch)
    notes = {P.root: _record_rejoins(monkeypatch, P) for P in (PORT, REF)}
    port, ref = _run(PORT, tmp_path, name), _run(REF, tmp_path, name)
    _assert_green(port)
    _assert_green(ref)
    if _report(port) != _report(ref):
        a, b = _report(port)["stats"], _report(ref)["stats"]
        print("stats that differ (port, reference):",
              {k: (a.get(k), b.get(k)) for k in sorted(set(a) | set(b)) if a.get(k) != b.get(k)})
        for root, n in notes.items():
            print(f"{root} re-bootstraps: {n}")
    assert _report(port) == _report(ref)
    assert port.digest == ref.digest == DIGESTS[name]
    return port


# ---------------------------------------------------------------------------
# the four canonical storms: invariants green, the expected signals fired
# ---------------------------------------------------------------------------


def test_crash_storm_survives_and_converges(tmp_path, monkeypatch):
    r = _run_both(tmp_path, "crash_storm", monkeypatch)
    assert r.failovers == 1 and r.rejoins >= 1
    assert r.epoch == 2
    assert r.faults_fired.get("replica_apply:replica-2") == 1
    assert r.final_seq >= r.watermark_seq


def test_slow_follower_breaker_routes_around(tmp_path, monkeypatch):
    r = _run_both(tmp_path, "slow_follower", monkeypatch)
    # the permanently failing replica tripped its serve breaker, and the
    # cooldown (virtual clock) re-admitted it after the fault cleared
    assert r.breaker_trips >= 1
    assert r.faults_fired.get("replica_serve:replica-1", 0) >= 1
    assert r.stats["breaker_trips"] >= 1
    assert r.stats["breakers_open"] == 0  # closed again by quiesce


def test_flash_crowd_sheds_and_recovers(tmp_path, monkeypatch):
    r = _run_both(tmp_path, "flash_crowd", monkeypatch)
    assert r.shed_raises >= 1  # brownout engaged under the 4x surge
    assert r.stats["rejected_brownout"] > 0  # cold traffic actually shed
    assert r.stats["shed_level"] == 0  # admission re-opened at quiesce


def test_partition_heal_fences_and_rejoins(tmp_path, monkeypatch):
    r = _run_both(tmp_path, "partition_heal", monkeypatch)
    assert r.failovers == 1 and r.rejoins == 1
    assert r.epoch == 2
    assert r.final_seq >= r.watermark_seq


def test_router_owners_follow_a_partition_rebound_at_a_reused_id(tmp_path, monkeypatch):
    """The crash-storm twin's rare split: a primary partition vector
    rebound to a new array at the freed one's ``id`` (forced here: every
    ``id`` in the cluster module the same) leaves the reference's router
    with the old owner map; the port's holds the vector it folded and
    folds the new one."""
    for P in (PORT, REF):
        h = P.chaos.ChaosHarness(tmp_path / P.root, P.chaos.scenario("crash_storm"),
                                 **P.loop_kw)
        router, ot = h.coord.router, h.coord.primary.ot
        monkeypatch.setattr(P.cluster, "id", lambda obj: 0, raising=False)
        before = router.owners().copy()
        ot.part = np.random.default_rng(5).permutation(ot.part)   # vertices move
        fresh = P.cluster.shard_assignment(ot.part, h.coord.n_replicas,
                                           block_n=h.coord.cfg.block_n)
        assert not np.array_equal(fresh, before)
        if P is PORT:
            assert np.array_equal(router.owners(), fresh)
        else:
            assert np.array_equal(router.owners(), before)  # the reference's stale map
        h.coord.stop()


# ---------------------------------------------------------------------------
# determinism: same scenario, same seed -> identical state digest
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(PORT.chaos.SCENARIOS))
def test_scenarios_are_bit_reproducible(tmp_path, name):
    a = _run(PORT, tmp_path, name, "a")
    b = _run(PORT, tmp_path, name, "b")
    _assert_green(a)
    _assert_green(b)
    assert a.digest == b.digest == DIGESTS[name]
    assert sorted(PORT.chaos.SCENARIOS) == sorted(REF.chaos.SCENARIOS) == sorted(DIGESTS)


def test_different_seeds_diverge(tmp_path, monkeypatch):
    """Seed 12 reaches the digest: its result is pinned, and differs from
    seed 11's.  The reference runs with synchronous snapshot writes (see
    :func:`test_crash_storm_off_its_seed_repeats`)."""
    _sync_snapshots(monkeypatch, REF)
    for P in (PORT, REF):
        a = _run_seeded(P, tmp_path / P.root / "a", 11)
        b = _run_seeded(P, tmp_path / P.root / "b", 12)
        _assert_green(a)
        _assert_green(b)
        assert a.digest == DIGESTS["crash_storm"]
        assert b.digest == STORM_OFF_SEED[12]  # the digest covers the workload


#: the crash storm's digest off its pinned seed: the port's, and the
#: reference's when its snapshot writes are synchronous
STORM_OFF_SEED = {
    12: "4f4d92300383692df9a653824bd459761f18c244f9fc08308d4a1a969794e7c9",
    13: "51f61477f37cd109c91b39b0eedeb887dcf863a51c292cfe246e1cb6f4fb67c4",
}

#: the reference's seed-12 result when the snapshot on commit has not been
#: published before a follower re-bootstraps: its follower skips the later
#: commit as covered, so the promoted primary and slot 0 part ways
REF_LATE_SNAPSHOT_12 = (
    "f977ec3a90524b4ebc3f65345f2fac134f94345a1e7e16ef83e5b29e53b0ef17",
    ["slot 0: dirty diverged from primary"])


def _run_seeded(P, d, seed):
    d.mkdir(parents=True, exist_ok=True)
    sc = P.chaos.scenario("crash_storm")
    sc.seed = seed
    return P.chaos.ChaosHarness(d, sc, **P.loop_kw).run()


@pytest.mark.parametrize("seed", sorted(STORM_OFF_SEED))
def test_crash_storm_off_its_seed_repeats(tmp_path, monkeypatch, seed):
    """Off its pinned seed the crash storm gives one digest and one verdict
    run after run, the reference's with synchronous snapshots.  (The
    snapshot on commit is written on a background thread; whether a
    follower's re-bootstrap read it or the one before used to decide the
    result.)"""
    results = {(r.digest, tuple(r.invariant_errors))
               for r in (_run_seeded(PORT, tmp_path / f"p{i}", seed)
                         for i in range(5))}
    assert results == {(STORM_OFF_SEED[seed], ())}
    _sync_snapshots(monkeypatch, REF)
    ref = _run_seeded(REF, tmp_path / "r", seed)
    _assert_green(ref)
    assert ref.digest == STORM_OFF_SEED[seed]


def test_crash_storm_at_seed_12_matches_the_reference(tmp_path, monkeypatch):
    """The cross-package comparison off the pinned seed: the whole report,
    the reference with synchronous snapshots."""
    _sync_snapshots(monkeypatch, REF)
    port = _run_seeded(PORT, tmp_path / "p", 12)
    ref = _run_seeded(REF, tmp_path / "r", 12)
    _assert_green(port)
    assert _report(port) == _report(ref)


@pytest.mark.parametrize("seed", sorted(STORM_OFF_SEED))
def test_bootstrap_from_an_older_snapshot_keeps_parity(tmp_path, monkeypatch,
                                                       seed):
    """A departure from the reference: a follower restored from a snapshot
    older than the primary's last commit adopts that commit at its own seq.
    The port's result does not depend on which snapshot the bootstrap read;
    the reference's follower skips the commit as covered (slot 0 diverges
    at seed 12, every time the snapshot is late)."""
    _late_snapshots(monkeypatch, PORT)
    _late_snapshots(monkeypatch, REF)
    port = _run_seeded(PORT, tmp_path / "p", seed)
    _assert_green(port)
    assert port.digest == STORM_OFF_SEED[seed]
    ref = _run_seeded(REF, tmp_path / "r", seed)
    assert not ref.ok
    if seed == 12:
        assert ref.digest == REF_LATE_SNAPSHOT_12[0]
        assert ref.invariant_errors == REF_LATE_SNAPSHOT_12[1]


# ---------------------------------------------------------------------------
# evidence: the flight recorder tells the whole story
# ---------------------------------------------------------------------------


def _evidence(P, tmp_path):
    h = P.chaos.ChaosHarness(tmp_path / P.root, P.chaos.scenario("crash_storm"), **P.loop_kw)
    r = h.run()
    _assert_green(r)
    rec = h.obs.recorder
    assert len(rec.events("promotion")) == r.failovers
    assert len(rec.events("rejoin")) == r.rejoins
    assert rec.events("fault_fired")
    assert rec.events("heartbeat_lapse")  # the forced-failover path
    # run() triggered a dump: the black box is on disk
    assert rec.dumps and rec.dumps[-1].exists()
    return [{k: v for k, v in e.items() if k not in ("t", "wall") and not k.endswith("_s")}
            for e in rec.events()], [p.name for p in rec.dumps]


def test_chaos_leaves_flight_recorder_evidence(tmp_path):
    """The recorder's events (clock readings aside) and dump files are the
    reference's."""
    assert _canon(_evidence(PORT, tmp_path)) == _canon(_evidence(REF, tmp_path))


def test_harness_rejects_unknown_action(tmp_path):
    sc = PORT.chaos.Scenario(name="bad", steps=1,
                             events=[PORT.chaos.ChaosEvent(0, "explode", {})])
    h = PORT.chaos.ChaosHarness(tmp_path, sc, device="cpu")
    with pytest.raises(ValueError, match="unknown chaos action"):
        h.run()
    h.coord.stop()


def test_unknown_scenario_name():
    with pytest.raises(ValueError, match="unknown scenario"):
        PORT.chaos.scenario("nope")


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_run_scenario_on_cpu_equals_pinned_digest(tmp_path, name):
    """``run_scenario`` with ``device="cpu"`` — the entry point the card's
    smoke script calls with ``device="cuda"``."""
    r = PORT.chaos.run_scenario(tmp_path, name, device="cpu")
    _assert_green(r)
    assert r.digest == DIGESTS[name]
    assert r.stats["backend_fallbacks"] == 0
