"""WAL-shipping replication on the port against the JAX package's.

Twins of ``tests/test_replication.py`` (transport faults — drop, delay,
reorder, link partition, per-follower qualified sites —, follower bootstrap
and bitwise parity at every shipped seq, gap-driven tail resync, the
compaction retention floor, replica crash and rejoin in both modes) and of
``tests/test_control.py``'s ship-channel breaker.  Every scenario runs
through ``repro_torch.serve`` (``device="cpu"``) and ``repro.serve`` in one
process on the same inputs: each package's follower is held to its own
primary as the reference test holds it, and what the two runs observe —
replica state, enumeration answers, the hub's and each follower's
``stats()`` — must be equal.  One case crosses packages frame by frame: the
frames the port's hub ships for a fixed stream are the reference's.

The helpers here (``PKGS``, ``_cluster``, ``_drive``, ``_state``,
``_canon``) are shared with the other cluster test files."""
import importlib
import types

import numpy as np

#: the two packages' module trees are the same, module for module
_MODULES = {
    "online": "core.online", "rpq": "core.rpq", "taper": "core.taper",
    "gen": "graphs.generators", "graph": "graphs.graph",
    "sharded_packing": "graphs.sharded_packing", "serve": "serve",
    "faults": "serve.faults", "replication": "serve.replication",
    "cluster": "serve.cluster", "chaos": "serve.chaos",
    "control": "serve.control", "snapshot": "serve.snapshot", "obs": "obs",
}


def _pkg(root, **loop_kw):
    ns = types.SimpleNamespace(root=root, loop_kw=loop_kw)
    for key, mod in _MODULES.items():
        setattr(ns, key, importlib.import_module(f"{root}.{mod}"))
    ns.MutationBatch = ns.graph.MutationBatch
    ns.MQ1 = ns.rpq.parse_rpq("Area.Artist.(Artist|Label).Area")
    ns.MQ3 = ns.rpq.parse_rpq("Artist.Credit.Track.Medium")
    return ns


REF = _pkg("repro")
PORT = _pkg("repro_torch", device="cpu")
PKGS = (REF, PORT)


def _canon(x):
    """``x`` with arrays as (dtype, shape, bytes) and numpy scalars as
    Python ones, so two packages' observations compare bitwise."""
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, dict):
        return {k: _canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_canon(v) for v in x]
    return x


def _both(scenario, tmp_path, *args, **kw):
    """Run ``scenario(P, tmp, ...)`` for the reference and the port (each in
    its own directory); their canonical observations must be equal."""
    obs = [_canon(scenario(P, tmp_path / P.root, *args, **kw)) for P in PKGS]
    assert obs[1] == obs[0]
    return obs[1]


def _policy(P):
    # durable-state-only triggers: a replica that adopted the shipped
    # commit stream re-decides invocations identically
    return P.online.OnlinePolicy(bootstrap_after_ticks=0, cadence=6, min_interval=0,
                                 dirty_fraction=0.02, drift_l1=9e9, ipt_regression=9e9)


def _cluster(P, tmp, n_followers=1, faults=None, snapshot_keep=3, n=400, obs=None,
             **ck):
    g = P.gen.musicbrainz_like(n, seed=7)
    cfg = P.serve.ServeLoopConfig(micro_batch=8, overlap_invocations=False,
                                  snapshot_dir=str(tmp), snapshot_keep=snapshot_keep,
                                  faults=faults, obs=obs)
    primary = P.serve.ServingLoop(g, 4, taper_config=P.taper.TaperConfig(max_iterations=2),
                                  policy=_policy(P), config=cfg, **P.loop_kw)
    ck.setdefault("heartbeat_timeout_s", 9e9)
    ccfg = P.serve.ClusterConfig(n_followers=n_followers, faults=faults, obs=obs, **ck)
    return P.serve.ClusterCoordinator(primary, config=ccfg, policy=_policy(P),
                                      taper_config=P.taper.TaperConfig(max_iterations=2))


def _drive(P, coord, rounds, seed=0, serve=True):
    """Deterministic serve+mutate+pump rounds against the coordinator."""
    rng = np.random.default_rng(seed)
    n = coord.primary.g.n
    for i in range(rounds):
        if serve:
            coord.serve([P.MQ1 if i % 3 else P.MQ3], cls="hot")
        r = rng.random()
        if r < 0.4:
            coord.submit_mutations(P.MutationBatch(
                add_vertex_labels=[int(rng.integers(0, 4))],
                add_edges=[(int(rng.integers(0, n)), n)]))
            n += 1
        elif r < 0.6:
            coord.submit_mutations(P.MutationBatch(
                add_edges=[(int(rng.integers(0, 400)), int(rng.integers(0, 400)))]))
        coord.pump()


def _state(ot):
    """The replicated state of an ``OnlineTaper``: graph arrays, version,
    partition, dirty bits, invocation count and the swap RNG's state."""
    g = ot.g
    return {"n": int(g.n), "version": int(g.version), "labels": g.labels,
            "src": g.src, "dst": g.dst, "row_ptr": g.row_ptr, "part": ot.part,
            "dirty": ot._dirty, "invocations": int(ot.invocations),
            "rng": ot.taper._rng.bit_generator.state}


def _answers(P, executor, ot):
    return [executor.enumerate_paths(q, max_results=16, part=ot.part)
            for q in (P.MQ1, P.MQ3)]


def _assert_replica_parity(P, f, loop):
    """Bitwise parity of a follower against a serving loop (the reference
    test's check); returns the follower's state and answers."""
    a, b = _canon(_state(f.ot)), _canon(_state(loop.ot))
    assert a == b
    ans = _answers(P, f.executor, f.ot)
    assert ans == _answers(P, loop.executor, loop.ot)
    return {"state": a, "answers": ans}


def _follower_stats(coord):
    """Each follower's ``stats()``; ``served`` only when no read hedged (a
    hedge fires on a wall-clock deadline, so its target is not a function
    of the stream)."""
    hedged = coord.router.stats()["hedged_requests"]
    out = {}
    for slot, f in sorted(coord.followers.items()):
        st = f.stats()
        if hedged:
            st.pop("served")
        out[slot] = st
    return out


def _health(coord):
    return {"hub": coord.hub.stats(), "followers": _follower_stats(coord)}


# ---------------------------------------------------------------------------
# steady-state shipping
# ---------------------------------------------------------------------------


def _bootstrap_and_shipped_parity(P, tmp):
    coord = _cluster(P, tmp, n_followers=2)
    _drive(P, coord, rounds=30, seed=0)
    out = {}
    for slot, f in coord.followers.items():
        f.catch_up()
        st = f.stats()
        assert st["seq_lag"] == 0 and st["full_resyncs"] == 0
        assert st["applied_groups"] > 0
        out[slot] = _assert_replica_parity(P, f, coord.primary)
    assert coord.primary.ot.invocations > 0
    assert coord.followers[1].stats()["applied_commits"] > 0
    out["health"] = _health(coord)
    coord.stop()
    return out


def test_follower_bootstrap_and_shipped_parity(tmp_path):
    """Followers bootstrap like a restarted node, then stay bitwise-equal
    to the primary through shipped groups and invocation commits."""
    _both(_bootstrap_and_shipped_parity, tmp_path)


def _ship_drop(P, tmp):
    fi = P.faults.FaultInjector()
    coord = _cluster(P, tmp, n_followers=1, faults=fi)
    f = coord.followers[1]
    _drive(P, coord, rounds=4, seed=1)
    # next heartbeat + the group for this mutation both drop
    fi.arm(f"{P.faults.SITE_SHIP_DROP}:replica-1", times=2)
    coord.submit_mutations(P.MutationBatch(add_edges=[(1, 2)]))
    coord.pump()
    assert f.stats()["channel_dropped"] >= 1
    for _ in range(4):  # gap persists resync_after_polls -> tail resync
        coord.pump()
    st = f.stats()
    assert st["seq_lag"] == 0
    assert st["tail_resyncs"] >= 1 and st["full_resyncs"] == 0
    out = {"parity": _assert_replica_parity(P, f, coord.primary), "health": _health(coord)}
    coord.stop()
    return out


def test_ship_drop_recovers_via_tail_resync(tmp_path):
    _both(_ship_drop, tmp_path)


def _delay_reorder(P, tmp):
    fi = P.faults.FaultInjector()
    coord = _cluster(P, tmp, n_followers=1, faults=fi)
    f = coord.followers[1]
    fi.arm(f"{P.faults.SITE_SHIP_DELAY}:replica-1", times=2)
    coord.submit_mutations(P.MutationBatch(add_edges=[(3, 4)]))
    coord.pump()
    coord.submit_mutations(P.MutationBatch(add_edges=[(5, 6)]))
    coord.pump()
    fi.arm(f"{P.faults.SITE_SHIP_REORDER}:replica-1", times=1)
    coord.submit_mutations(P.MutationBatch(add_edges=[(7, 8)]))
    for _ in range(5):
        coord.pump()
    st = f.stats()
    assert st["channel_delayed"] >= 1
    assert st["channel_reordered"] >= 1
    assert st["seq_lag"] == 0 and st["full_resyncs"] == 0
    out = {"parity": _assert_replica_parity(P, f, coord.primary), "health": _health(coord)}
    coord.stop()
    return out


def test_ship_delay_and_reorder_are_absorbed(tmp_path):
    _both(_delay_reorder, tmp_path)


def _qualified_site(P, tmp):
    fi = P.faults.FaultInjector()
    coord = _cluster(P, tmp, n_followers=2, faults=fi)
    fi.arm(f"{P.faults.SITE_SHIP_DROP}:replica-1", times=3)
    _drive(P, coord, rounds=10, seed=2, serve=False)
    for _ in range(4):
        coord.pump()
    assert coord.followers[1].stats()["channel_dropped"] >= 1
    assert coord.followers[2].stats()["channel_dropped"] == 0
    out = {slot: _assert_replica_parity(P, f, coord.primary)
           for slot, f in coord.followers.items()}
    out["health"] = _health(coord)
    coord.stop()
    return out


def test_qualified_site_targets_one_follower(tmp_path):
    _both(_qualified_site, tmp_path)


# ---------------------------------------------------------------------------
# partition + retention floor
# ---------------------------------------------------------------------------


def _link_partition(P, tmp):
    fi = P.faults.FaultInjector()
    coord = _cluster(P, tmp, n_followers=1, faults=fi)
    f = coord.followers[1]
    _drive(P, coord, rounds=4, seed=3, serve=False)
    f.catch_up()
    acked0 = coord.hub.acked()["replica-1"]
    fi.arm(f"{P.faults.SITE_LINK_PARTITION}:replica-1")
    _drive(P, coord, rounds=8, seed=4, serve=False)
    st = f.stats()
    assert st["channel_blocked"] >= 1
    assert st["seq_lag"] > 0
    # no acks across the blackhole: the floor pins at the pre-partition seq
    assert coord.hub.acked()["replica-1"] == acked0
    assert coord.primary._journal.retain_floor == acked0
    fi.disarm(f"{P.faults.SITE_LINK_PARTITION}:replica-1")
    for _ in range(4):
        coord.pump()
    st = f.stats()
    assert st["seq_lag"] == 0
    assert st["tail_resyncs"] >= 1 and st["full_resyncs"] == 0
    out = {"acked0": acked0, "parity": _assert_replica_parity(P, f, coord.primary),
           "health": _health(coord)}
    coord.stop()
    return out


def test_link_partition_blackholes_then_heals_by_tail_replay(tmp_path):
    _both(_link_partition, tmp_path)


def _retention_keep_1(P, tmp):
    fi = P.faults.FaultInjector()
    coord = _cluster(P, tmp, n_followers=1, faults=fi, snapshot_keep=1)
    f = coord.followers[1]
    _drive(P, coord, rounds=4, seed=5)
    f.catch_up()
    fi.arm(f"{P.faults.SITE_LINK_PARTITION}:replica-1")
    # serve-driven rounds so invocation commits fire -> snapshots -> compaction
    _drive(P, coord, rounds=24, seed=6)
    assert coord.primary.stats()["snapshots_taken"] >= 2
    # the journal still reaches back to the follower's acked position
    acked = coord.hub.acked()["replica-1"]
    tail = coord.primary._journal.replay(after_seq=acked)
    assert [s for s, _, _ in tail][:1] == [acked + 1] or not tail
    fi.disarm(f"{P.faults.SITE_LINK_PARTITION}:replica-1")
    for _ in range(4):
        coord.pump()
    st = f.stats()
    assert st["seq_lag"] == 0
    assert st["full_resyncs"] == 0  # tail replay sufficed
    out = {"tail": [s for s, _, _ in tail],
           "parity": _assert_replica_parity(P, f, coord.primary), "health": _health(coord)}
    coord.stop()
    return out


def test_retention_floor_slow_follower_survives_keep_1(tmp_path):
    _both(_retention_keep_1, tmp_path)


def _dead_replica(P, tmp):
    coord = _cluster(P, tmp, n_followers=1, snapshot_keep=1)
    f = coord.followers[1]
    _drive(P, coord, rounds=4, seed=7)
    f.catch_up()
    f.crash()
    _drive(P, coord, rounds=24, seed=8)
    # compaction ran unclamped: the tail no longer reaches the dead replica
    assert coord.primary._journal.retain_floor is None
    f.rejoin(reuse_state=True)
    for _ in range(4):
        coord.pump()
    st = f.stats()
    assert st["full_resyncs"] >= 1
    assert st["seq_lag"] == 0
    out = {"parity": _assert_replica_parity(P, f, coord.primary), "health": _health(coord)}
    coord.stop()
    return out


def test_dead_replica_does_not_pin_the_wal(tmp_path):
    _both(_dead_replica, tmp_path)


# ---------------------------------------------------------------------------
# replica crash / rejoin
# ---------------------------------------------------------------------------


def _crash_rejoin(P, tmp):
    fi = P.faults.FaultInjector()
    coord = _cluster(P, tmp, n_followers=1, faults=fi)
    f = coord.followers[1]
    _drive(P, coord, rounds=4, seed=9, serve=False)
    fi.arm(f"{P.faults.SITE_REPLICA_APPLY}:replica-1", times=1)
    coord.submit_mutations(P.MutationBatch(add_edges=[(9, 10)]))
    coord.pump()
    assert not f.alive and f.crash_error is not None
    _drive(P, coord, rounds=6, seed=10, serve=False)
    f.rejoin(reuse_state=True)
    assert f.alive
    st = f.stats()
    assert st["seq_lag"] == 0 and st["full_resyncs"] == 0
    out = {"kept": _assert_replica_parity(P, f, coord.primary)}
    # crash again; this time the process is "lost" -> full bootstrap
    f.crash()
    _drive(P, coord, rounds=6, seed=11, serve=False)
    f.rejoin(reuse_state=False)
    for _ in range(2):
        coord.pump()
    assert f.stats()["seq_lag"] == 0
    out["lost"] = _assert_replica_parity(P, f, coord.primary)
    out["health"] = _health(coord)
    coord.stop()
    return out


def test_replica_crash_and_rejoin_both_modes(tmp_path):
    _both(_crash_rejoin, tmp_path)


# ---------------------------------------------------------------------------
# the ship channel's breaker (test_control.py's twin)
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self, t0=0.0):
        self.t = float(t0)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _channel_breaker(P, tmp):
    clk = FakeClock()
    rep = P.replication
    ch = rep.ShipChannel("replica-1")
    ch.breaker = P.control.Breaker("ship-replica-1", window=4, min_failures=1,
                                   error_rate=1.0, cooldown_s=5.0, clock=clk)
    ch.breaker.record_failure()  # link declared dead
    assert not ch.send(rep.Frame(kind="commit", epoch=1, seq=1))
    assert ch.breaker_fastfail == 1 and ch.blocked == 1
    # half-open probe after cooldown actually attempts the transport
    clk.advance(5.01)
    assert ch.send(rep.Frame(kind="commit", epoch=1, seq=2))
    assert ch.breaker.state == "closed"
    got = ch.receive()
    return {"received": [(f.kind, f.epoch, f.seq) for f in got],
            "counters": [ch.sent, ch.dropped, ch.blocked, ch.breaker_fastfail,
                         ch.breaker.trips, ch.breaker.state]}


def test_ship_channel_breaker_fast_fails_open_link(tmp_path):
    _both(_channel_breaker, tmp_path)


# ---------------------------------------------------------------------------
# across packages: the shipped frames themselves
# ---------------------------------------------------------------------------


def _frame(f):
    return {"kind": f.kind, "epoch": f.epoch, "seq": f.seq,
            "commit_index": f.commit_index, "force": f.force, "payload": f.payload}


def _shipped_frames(P, tmp):
    """Every frame the hub broadcasts over a fixed stream with a drop, a
    delay and a reorder on the link, then what the tail resync re-reads."""
    fi = P.faults.FaultInjector()
    coord = _cluster(P, tmp, n_followers=1, faults=fi)
    hub, sent = coord.hub, []
    broadcast = hub._broadcast

    def record(frame):
        sent.append(_frame(frame))
        broadcast(frame)

    hub._broadcast = record
    _drive(P, coord, rounds=12, seed=0, serve=False)
    fi.arm(f"{P.faults.SITE_SHIP_DROP}:replica-1", times=2)
    fi.arm(f"{P.faults.SITE_SHIP_DELAY}:replica-1", times=1)
    _drive(P, coord, rounds=18, seed=12)
    coord.followers[1].catch_up()
    assert coord.primary.ot.invocations > 0
    kinds = {f["kind"] for f in sent}
    assert kinds == {"group", "commit", "heartbeat"}
    # what a resync from the oldest retained journal record re-reads
    seqs = [s for s, _, _ in coord.primary._journal.replay()]
    tail = [_frame(f) for f in hub.tail(seqs[0] - 1 if seqs else hub.primary_seq, 0)]
    parity = _assert_replica_parity(P, coord.followers[1], coord.primary)
    coord.stop()
    return {"sent": sent, "tail": tail, "parity": parity}


def test_shipped_frames_equal_reference(tmp_path):
    """Frame for frame — kind, epoch, seq, commit index, force flag and the
    payload (members' WAL bytes, commit state arrays, RNG state) — the
    port's hub ships what the reference's ships."""
    out = _both(_shipped_frames, tmp_path)
    assert len(out["sent"]) > 30
