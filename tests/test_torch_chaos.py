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
import pytest

from test_torch_replication import PORT, REF, _canon

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


def _run_both(tmp_path, name):
    """The port's report, after holding it to the reference's and its
    digest to the pinned constant."""
    port, ref = _run(PORT, tmp_path, name), _run(REF, tmp_path, name)
    _assert_green(port)
    _assert_green(ref)
    assert _report(port) == _report(ref)
    assert port.digest == ref.digest == DIGESTS[name]
    return port


# ---------------------------------------------------------------------------
# the four canonical storms: invariants green, the expected signals fired
# ---------------------------------------------------------------------------


def test_crash_storm_survives_and_converges(tmp_path):
    r = _run_both(tmp_path, "crash_storm")
    assert r.failovers == 1 and r.rejoins >= 1
    assert r.epoch == 2
    assert r.faults_fired.get("replica_apply:replica-2") == 1
    assert r.final_seq >= r.watermark_seq


def test_slow_follower_breaker_routes_around(tmp_path):
    r = _run_both(tmp_path, "slow_follower")
    # the permanently failing replica tripped its serve breaker, and the
    # cooldown (virtual clock) re-admitted it after the fault cleared
    assert r.breaker_trips >= 1
    assert r.faults_fired.get("replica_serve:replica-1", 0) >= 1
    assert r.stats["breaker_trips"] >= 1
    assert r.stats["breakers_open"] == 0  # closed again by quiesce


def test_flash_crowd_sheds_and_recovers(tmp_path):
    r = _run_both(tmp_path, "flash_crowd")
    assert r.shed_raises >= 1  # brownout engaged under the 4x surge
    assert r.stats["rejected_brownout"] > 0  # cold traffic actually shed
    assert r.stats["shed_level"] == 0  # admission re-opened at quiesce


def test_partition_heal_fences_and_rejoins(tmp_path):
    r = _run_both(tmp_path, "partition_heal")
    assert r.failovers == 1 and r.rejoins == 1
    assert r.epoch == 2
    assert r.final_seq >= r.watermark_seq


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


def test_different_seeds_diverge(tmp_path):
    for P in (PORT, REF):
        sc = P.chaos.scenario("crash_storm")
        a = P.chaos.ChaosHarness(tmp_path / P.root / "a", sc, **P.loop_kw).run()
        sc2 = P.chaos.scenario("crash_storm")
        sc2.seed = sc.seed + 1
        b = P.chaos.ChaosHarness(tmp_path / P.root / "b", sc2, **P.loop_kw).run()
        assert a.digest == DIGESTS["crash_storm"]
        assert a.digest != b.digest  # the digest actually covers the workload


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
