"""Replicated cluster serving on the port against the JAX package's.

Twins of ``tests/test_cluster.py`` — owner routing, cross-replica ipt
accounting, bounded-staleness reads, deadline hedging, read failover and
the failover drill (crash, promote under a new epoch, bitwise-identical
answers against an uninterrupted run at the same applied seq, fenced
zombie, rejoin by catch-up replay).  Every scenario runs through both
packages (the port with ``device="cpu"``); the promoted primary, the
routed reads and the rejoined node must equal the reference's at every
step.  Beyond the twins: ``majority_owner``, ``ShardedVMPacking.owner_of``
and ``exchange_metrics`` against the reference; a ``KernelError`` is no
replica fault (the router re-raises it) and no failover trigger (the
primary's propagates from ``ClusterCoordinator.pump``); every node of a
cluster built on the CPU lives on the CPU."""
import time

import numpy as np
import pytest

from repro_torch.kernels import KernelError
from test_torch_replication import (  # same-directory sibling
    PORT, REF, _both, _canon, _cluster, _drive, _state)


def _answers(P, loop):
    return [loop.executor.enumerate_paths(q, max_results=16, part=loop.ot.part)
            for q in (P.MQ1, P.MQ3)]


def _direct(P, coord, queries):
    return coord.primary.executor.enumerate_paths_many(
        queries, max_results=coord.cfg.max_results_per_query, part=coord.primary.ot.part)


# ---------------------------------------------------------------------------
# routing + ipt accounting
# ---------------------------------------------------------------------------


def test_majority_owner_fold():
    for P in (PORT, REF):
        mo = P.sharded_packing.majority_owner
        owner_of = np.array([0, 0, 1, 1, 2], np.int32)
        assert mo(owner_of, np.array([0, 1, 2])) == 0
        assert mo(owner_of, np.array([2, 3, 4])) == 1
        assert mo(owner_of, np.array([], np.int64)) == 0


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_owner_fold_and_exchange_metrics_equal_reference(n_shards):
    """``majority_owner`` over ``ShardedVMPacking.owner_of``'s fold and over
    ``shard_assignment``'s, and the packing's ``exchange_metrics``: the
    port's answers are the reference's."""
    rng = np.random.default_rng(n_shards)
    part = rng.integers(0, 4, 400)
    order = REF.sharded_packing.partition_shard_order(part, n_shards)
    got = []
    for P in (REF, PORT):
        g = P.gen.musicbrainz_like(400, seed=7)
        sp = g.vm_packing_sharded(n_shards, block_n=32, block_e=64, order=order,
                                  order_token="partition:0")
        owner = sp.owner_of(np.arange(g.n))
        folds = (owner, P.sharded_packing.shard_assignment(part, n_shards, block_n=32))
        sets = [rng_v for rng_v in np.random.default_rng(0).integers(0, g.n, (20, 9))]
        got.append(_canon({
            "owner_of": owner, "one": sp.owner_of(17),
            "metrics": [sp.exchange_metrics(t, g.n) for t in (5, 23)],
            "majority": [[P.sharded_packing.majority_owner(f, v) for v in sets]
                         for f in folds]}))
    assert got[1] == got[0]


def _owner_routing(P, tmp):
    coord = _cluster(P, tmp, n_followers=2)
    r = coord.router
    owners = r.owners()
    assert np.array_equal(owners, P.sharded_packing.shard_assignment(
        coord.primary.ot.part, coord.n_replicas, block_n=coord.cfg.block_n))
    routes = []
    for q in (P.MQ1, P.MQ3):
        plan = coord.primary.executor._enum_plan(q)
        starts = np.nonzero(np.isin(coord.primary.g.labels, plan.first_labels))[0]
        assert r.route(q) == P.sharded_packing.majority_owner(owners, starts)
        routes.append(r.route(q))
    res = coord.serve([P.MQ1, P.MQ3, P.MQ3], cls="hot")
    st = r.stats()
    assert st["routed"] == 3
    assert sum(st["routed_by_slot"].values()) == 3
    coord.stop()
    return {"owners": owners, "routes": routes, "res": res,
            "routed_by_slot": st["routed_by_slot"]}


def test_owner_routing_matches_shard_assignment(tmp_path):
    _both(_owner_routing, tmp_path)


def _cross_ipt(P, tmp):
    coord = _cluster(P, tmp, n_followers=2)
    # capture the owner fold first: observe_served may trigger an
    # invocation right after the ipt accounting, swapping the partition
    owners = coord.router.owners().copy()
    res = coord.serve([P.MQ3] * 4, cls="hot")
    expect = 0.0
    for paths, _ in res:
        for p in paths:
            if len(p) > 1:
                ov = owners[np.asarray(p, dtype=np.int64)]
                expect += float((ov[1:] != ov[:-1]).sum())
    assert coord.router.stats()["cross_replica_ipt"] == expect
    assert expect > 0  # 4-hop paths across a 3-way block deal must cross
    coord.stop()
    return {"res": res, "ipt": expect}


def test_cross_replica_ipt_accounting(tmp_path):
    _both(_cross_ipt, tmp_path)


# ---------------------------------------------------------------------------
# bounded staleness + hedging + read failover
# ---------------------------------------------------------------------------


def _staleness(P, tmp):
    fi = P.faults.FaultInjector()
    coord = _cluster(P, tmp, n_followers=1, faults=fi,
                     max_staleness_versions={"hot": 0, "cold": 16})
    f = coord.followers[1]
    fi.arm("link_partition:replica-1")
    for _ in range(3):
        coord.submit_mutations(P.MutationBatch(add_edges=[(1, 2)]))
        coord.pump()
    lag = f.version_lag
    assert lag > 0
    assert coord.router._usable(1, "hot") == coord.primary_slot
    assert coord.router.stats()["staleness_fallbacks"] == 1
    # a cold read tolerates the lag and still lands on the follower
    assert coord.router._usable(1, "cold") == 1
    # heal: catch-up brings it back inside the hot bound
    fi.disarm("link_partition:replica-1")
    assert coord.router._usable(1, "hot") == 1
    assert coord.router.stats()["staleness_fallbacks"] == 1
    # a dead follower is redirected without a catch-up attempt
    f.crash()
    assert coord.router._usable(1, "hot") == coord.primary_slot
    assert coord.router.stats()["dead_redirects"] == 1
    out = {"lag": lag, "router": coord.router.stats(), "follower": f.stats()}
    coord.stop()
    return out


def test_bounded_staleness_gate(tmp_path):
    _both(_staleness, tmp_path)


def _hedging(P, tmp):
    fi = P.faults.FaultInjector()
    coord = _cluster(P, tmp, n_followers=1, faults=fi,
                     slo_budget_s={"hot": 0.01, "cold": 0.5})
    coord.router.route = lambda q: 1  # pin the read to the follower
    fi.arm(f"{P.faults.SITE_REPLICA_SERVE}:replica-1", mode="stall", times=1, delay_s=0.1)
    # reference answer before serving: the observation fold after the read
    # may trigger an invocation and swap the partition
    direct = _direct(P, coord, [P.MQ3])
    res = coord.serve([P.MQ3], cls="hot")
    st = coord.router.stats()
    assert st["hedged_requests"] == 1
    assert st["hedged_rate"] > 0
    # the hedged answer is bitwise the replica-parity answer
    assert res == direct
    coord.stop()
    return {"res": res, "hedged": st["hedged_requests"], "routed": st["routed_by_slot"]}


def test_deadline_hedging_past_slo_budget(tmp_path):
    _both(_hedging, tmp_path)


def _read_failover(P, tmp):
    fi = P.faults.FaultInjector()
    coord = _cluster(P, tmp, n_followers=1, faults=fi)
    coord.router.route = lambda q: 1
    fi.arm(f"{P.faults.SITE_REPLICA_SERVE}:replica-1", mode="raise", times=1)
    direct = _direct(P, coord, [P.MQ3])
    res = coord.serve([P.MQ3], cls="hot")
    assert coord.router.stats()["read_failovers"] == 1
    assert res == direct
    out = {"res": res, "follower": coord.followers[1].stats()}
    coord.stop()
    return out


def test_replica_serve_fault_fails_over_to_primary(tmp_path):
    """A raising replica read (not just a slow one) retries on the primary."""
    _both(_read_failover, tmp_path)


# ---------------------------------------------------------------------------
# the failover drill
# ---------------------------------------------------------------------------


def _assert_loop_parity(a, b):
    """Bitwise parity between two serving loops' replicated state."""
    assert _canon(_state(a.ot)) == _canon(_state(b.ot))


def _drill(P, tmp):
    A = _cluster(P, tmp / "a", n_followers=2, heartbeat_timeout_s=0.05)
    B = _cluster(P, tmp / "b", n_followers=2)
    _drive(P, A, rounds=18, seed=3)
    _drive(P, B, rounds=18, seed=3)
    assert A.primary._applied_seq == B.primary._applied_seq
    assert A.primary.ot.invocations > 0  # the drill spans commits
    steps = {"before": _state(A.primary.ot)}

    # crash mid-stream: the submitted-but-unpumped mutation below is the
    # primary's unacknowledged write — it dies with the process
    A.submit_mutations(P.MutationBatch(add_edges=[(1, 2)]))
    old_primary, old_slot = A.primary, A.primary_slot
    A.crash_primary()
    time.sleep(0.06)
    A.pump()

    st = A.stats()
    assert A.primary is not old_primary
    assert st["cluster_epoch"] == 2 and st["failovers"] == 1
    assert A.primary_slot != old_slot
    assert A.primary._epoch == 2
    # promoted at the same applied seq as the uninterrupted run
    assert A.primary._applied_seq == B.primary._applied_seq
    _assert_loop_parity(A.primary, B.primary)
    assert _answers(P, A.primary) == _answers(P, B.primary)
    # the routed read path agrees too (followers re-converged on the
    # promoted node's epoch-opening commit frame)
    routed = A.serve([P.MQ3], cls="hot")
    assert routed == B.serve([P.MQ3], cls="hot")
    steps["promoted"] = {"slot": A.primary_slot, "seq": A.primary._applied_seq,
                         "state": _state(A.primary.ot), "answers": _answers(P, A.primary),
                         "routed": routed}

    # the zombie's late snapshot publish carries the stale epoch
    fw0 = old_primary.stats()["fenced_writes"]
    old_primary.snapshot(sync=True)
    zst = old_primary.stats()
    assert zst["fenced_writes"] > fw0
    assert zst["fenced"] == 1 and zst["epoch"] == 1
    assert zst["cluster_epoch"] == 2
    steps["zombie"] = [zst["fenced_writes"], zst["fenced"], zst["epoch"]]

    # demoted node rejoins as a follower by catch-up replay alone
    f = A.rejoin_demoted(slot=old_slot, reuse_state=True)
    _drive(P, A, rounds=6, seed=4)
    f.catch_up()
    fs = f.stats()
    assert fs["seq_lag"] == 0 and fs["full_resyncs"] == 0
    assert _canon(_state(f.ot)) == _canon(_state(A.primary.ot))
    assert A.stats()["rejoins"] == 1
    steps["rejoined"] = {"state": _state(f.ot), "answers": _answers(P, A.primary),
                         "hub": A.hub.stats()}
    A.stop()
    B.stop()
    return steps


def test_failover_drill_bitwise_parity(tmp_path):
    """Crash one of two identical clusters' primaries; the best follower
    promotes under epoch 2 and answers bitwise like the uninterrupted
    cluster; the zombie's write fences; the demoted node rejoins by
    catch-up replay — each step equal to the reference's."""
    _both(_drill, tmp_path)


def _health_stats(P, tmp):
    coord = _cluster(P, tmp, n_followers=2, heartbeat_timeout_s=0.05)
    _drive(P, coord, rounds=8, seed=5)
    st = coord.stats()
    assert st["n_replicas"] == 3 and st["primary_slot"] == 0
    assert st["cluster_epoch"] == 1 and st["failovers"] == 0
    assert st["staleness_bound_versions"] == {"hot": 4, "cold": 16}
    assert set(st["followers"]) == {"replica-1", "replica-2"}
    for fs in st["followers"].values():
        assert {"applied_seq", "shipped_seq", "seq_lag", "version_lag",
                "applied_commits", "tail_resyncs"} <= set(fs)
    assert st["max_seq_lag"] >= 0 and st["hedged_rate"] >= 0
    keys = ("n_replicas", "primary_slot", "failovers", "rejoins", "cluster_epoch",
            "fencing_rejections", "max_seq_lag", "max_version_lag", "full_resyncs",
            "tail_resyncs")
    before = {k: st[k] for k in keys}
    coord.crash_primary()
    time.sleep(0.06)
    coord.pump()
    st = coord.stats()
    assert st["failovers"] == 1 and st["cluster_epoch"] == 2
    assert st["epoch"] == 2  # the stats now come from the promoted node
    out = {"before": before, "after": {k: st[k] for k in keys}, "collect": coord.collect()}
    coord.stop()
    return out


def test_cluster_stats_surface_replication_health(tmp_path):
    _both(_health_stats, tmp_path)


# ---------------------------------------------------------------------------
# a failed kernel is neither a replica fault nor a failover trigger
# ---------------------------------------------------------------------------


def test_kernel_error_is_not_caught_by_read_failover(tmp_path):
    """A replica read that raises ``KernelError`` propagates — it does not
    retry on the primary as an injected fault does — and neither does one
    raised by a hedge's second read."""
    fi = PORT.faults.FaultInjector()
    coord = _cluster(PORT, tmp_path, n_followers=1, faults=fi)
    coord.router.route = lambda q: 1
    fi.arm(f"{PORT.faults.SITE_REPLICA_SERVE}:replica-1", times=1, exc=KernelError)
    with pytest.raises(KernelError):
        coord.serve([PORT.MQ3], cls="hot")
    assert coord.router.stats()["read_failovers"] == 0
    # the hedge: the primary's read misses a zero budget, the alternate
    # (the follower) raises KernelError
    coord.router.route = lambda q: 0
    coord.cfg.slo_budget_s = {"hot": 0.0, "cold": 0.5}
    fi.arm(f"{PORT.faults.SITE_REPLICA_SERVE}:replica-1", times=1, exc=KernelError)
    with pytest.raises(KernelError):
        coord.serve([PORT.MQ3], cls="hot")
    st = coord.router.stats()
    assert st["read_failovers"] == 0 and st["hedged_requests"] == 0
    assert fi.fired_total() == 2
    coord.stop()


def test_kernel_error_in_primary_pump_propagates_without_failover(tmp_path):
    """A ``KernelError`` in the primary's invocation comes out of
    ``ClusterCoordinator.pump``: no failover, no epoch change, no ladder
    strike; the next pump raises it again and ``stop`` raises it."""
    fi = PORT.faults.FaultInjector()
    coord = _cluster(PORT, tmp_path, n_followers=1, faults=fi, heartbeat_timeout_s=0.05)
    primary = coord.primary
    fi.arm(PORT.faults.SITE_INVOCATION, times=-1, exc=KernelError)
    t_end = time.monotonic() + 30.0
    raised = False
    while not raised:
        assert time.monotonic() < t_end, "no KernelError within 30 s"
        primary.submit(PORT.MQ3)
        coord.submit_mutations(PORT.MutationBatch(add_edges=[(1, 2)]))
        try:
            coord.pump()
        except KernelError:
            raised = True
    time.sleep(0.06)  # past the heartbeat timeout: still no failover
    with pytest.raises(KernelError):
        coord.pump()
    st = coord.stats()
    assert coord.primary is primary and coord.failovers == 0
    assert coord.hub.current_epoch == 1 and st["cluster_epoch"] == 1
    assert st["backend_fallbacks"] == 0 and st["field_backend"] == "torch"
    assert fi.fired_total() == 1 and primary.ot.invocations == 0
    with pytest.raises(KernelError):
        coord.stop()


# ---------------------------------------------------------------------------
# device: followers live where the primary does
# ---------------------------------------------------------------------------


def test_cluster_on_cpu_keeps_every_node_on_cpu(tmp_path):
    """Followers, the promoted node and a rejoined node (both rejoin modes)
    of a cluster whose primary is on the CPU all evaluate on the CPU, the
    promoted loop on the ``torch`` rung; a follower on another device than
    the one asked for raises."""
    coord = _cluster(PORT, tmp_path, n_followers=2, heartbeat_timeout_s=0.05)
    assert coord.device.type == "cpu"

    def devices():
        return ({coord.primary.ot.taper.device.type}
                | {f.ot.taper.device.type for f in coord.followers.values()}
                | {f.device.type for f in coord.followers.values()})

    assert devices() == {"cpu"}
    _drive(PORT, coord, rounds=12, seed=3)
    old_slot = coord.primary_slot
    coord.crash_primary()
    time.sleep(0.06)
    coord.pump()
    assert coord.failovers == 1 and devices() == {"cpu"}
    assert coord.primary._base_backend == "torch"
    f = coord.rejoin_demoted(slot=old_slot, reuse_state=False)
    assert f.ot.taper.device.type == "cpu" and devices() == {"cpu"}
    old_slot = coord.primary_slot
    coord.partition_primary()
    time.sleep(0.06)
    coord.pump()
    assert coord.failovers == 2
    f = coord.rejoin_demoted(slot=old_slot, reuse_state=True)
    assert f.ot.taper.device.type == "cpu" and devices() == {"cpu"}
    _drive(PORT, coord, rounds=6, seed=4)
    for f in coord.followers.values():
        f.catch_up()
        assert _canon(_state(f.ot)) == _canon(_state(coord.primary.ot))
    with pytest.raises(ValueError, match="not on cuda"):
        PORT.replication.FollowerReplica(f.ot, coord.hub, "replica-x", device="cuda")
    coord.stop()
