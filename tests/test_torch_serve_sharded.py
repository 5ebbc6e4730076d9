"""Threaded sharded serving across ranks (``serve/sharded.py``): rank 0 runs
the threaded ``ServingLoop`` with overlapped invocations under
``torch_sharded``, ranks 1..S-1 a ``ShardFollower``, all spawned as gloo
ranks on the CPU (``launch/mesh.py::run_ranks``).

After every commit each follower's partition is rank 0's bit for bit;
rank 0's logged schedule, replayed inline in rank 0's process through the
single-device ``torch`` field, commits the same partitions; an ingest that
arrives while a run is in flight is applied after its commit on every
rank; a follower's injected ``KernelError``, before its run or inside
the field, reaches rank 0, which stops invoking and raises it from
``stop()``; a follower whose leader goes
silent raises within ``stop_timeout_s``.  Then threaded twins of
``tests/test_serve_loop.py``'s ``test_threaded_loop_serves_and_invokes``
and ``test_sharded_warm_path_uploads_only_dirty_shards``.

Every rank arms ``faulthandler`` to end its process past ``DEADLINE_S``,
so a rank that hangs fails the test instead of holding it."""
import faulthandler
import threading
import time

import numpy as np
import pytest

from repro_torch.core.online import OnlinePolicy, OnlineTaper
from repro_torch.core.rpq import parse_rpq
from repro_torch.core.taper import TaperConfig
from repro_torch.graphs import generators as PG
from repro_torch.graphs.graph import MutationBatch
from repro_torch.kernels import KernelError
from repro_torch.launch.mesh import run_ranks
from repro_torch.serve import ServeLoopConfig, ServingLoop
from repro_torch.serve.faults import SITE_INVOCATION, FaultInjector
from repro_torch.serve.sharded import ControlGroups, ShardFollower, replay_schedule

MQ1 = parse_rpq("Area.Artist.(Artist|Label).Area")
MQ3 = parse_rpq("Artist.Credit.Track.Medium")
#: a rank process that runs longer than this ends itself
DEADLINE_S = 150
#: the longest a rank waits on one event
WAIT_S = 60.0


def _deadline():
    faulthandler.dump_traceback_later(DEADLINE_S, exit=True)


def _until(cond, what, wait_s=WAIT_S):
    t_end = time.monotonic() + wait_s
    while not cond():
        if time.monotonic() > t_end:
            raise TimeoutError(f"waited {wait_s:g} s for {what}")
        time.sleep(0.002)


def _tc(backend="torch_sharded", source="stripe"):
    return TaperConfig(max_iterations=2, field_backend=backend, shard_map_source=source)


def _topology_policy():
    return OnlinePolicy(bootstrap_after_ticks=0, cadence=10 ** 9, dirty_fraction=0.001,
                        drift_l1=9e9)


def _cfg(**kw):
    return ServeLoopConfig(**dict(dict(micro_batch=8, batch_wait_s=0.002, stop_timeout_s=30.0,
                                       record_schedule=True), **kw))


def _follow(g, k, policy, cfg, tc=None):
    f = ShardFollower(g, k, taper_config=tc or _tc(), policy=policy, config=cfg, device="cpu")
    out = {"error": None}
    try:
        out["stats"] = f.run()
    except BaseException as exc:        # returned to the parent
        out["error"] = f"{type(exc).__name__}: {exc}"
    ups = f.ot.taper._pre.get("_shard_uploads") or {}
    out.update(commits=f.commits, trace=f.trace, part=f.ot.part.copy(),
               version=int(g.version), m=g.m, rebuilds=ups.get("rebuilds"))
    return out


# ---------------------------------------------------------------------------
# the ranks agree: partitions, replay, deferred ingest
# ---------------------------------------------------------------------------


def _gate_first_run(loop):
    """Hold rank 0's first run at its start until the returned event is set
    (the followers wait in the field's first collective)."""
    release = threading.Event()
    run = loop.ot.run_invocation
    held = []

    def gated(pending, should_abort=None):
        if not held:
            held.append(1)
            assert release.wait(WAIT_S), "the test never released the invocation"
        return run(pending, should_abort=should_abort)

    loop.ot.run_invocation = gated
    return release


def _agree_rank(rank, n_ranks, source):
    _deadline()
    g = PG.musicbrainz_like(700, seed=12)
    if rank:
        return _follow(g, 4, _topology_policy(), _cfg(), _tc(source=source))
    loop = ServingLoop(g, 4, taper_config=_tc(source=source), policy=_topology_policy(),
                       config=_cfg(), device="cpu")
    release = _gate_first_run(loop)
    loop.start()
    tickets = [loop.submit(MQ1 if i % 3 else MQ3) for i in range(16)]
    _until(lambda: loop.invocation_in_flight, "the bootstrap invocation")
    n0, v0 = g.n, int(g.version)
    # arrives while the run is in flight: deferred until after its commit
    loop.submit_mutations(MutationBatch(add_vertex_labels=[0], add_edges=[(n0, 1), (n0, 7)]))
    time.sleep(0.05)
    deferred = int(g.version) == v0
    release.set()
    _until(lambda: loop.ot.invocations >= 1 and int(g.version) > v0, "the deferred ingest")
    # the ingest dirtied vertices: the topology trigger fires on the next ticks
    loop.submit_mutations(MutationBatch(add_edges=[(3, 11), (5, 13)]))
    while loop.ot.invocations < 3:
        tickets += [loop.submit(MQ1) for _ in range(8)]
        _until(lambda: all(t.done.is_set() for t in tickets), "the requests")
        if len(tickets) > 400:
            break
    stats = loop.stop()
    schedule = loop.schedule
    # rank 0's schedule replayed inline in this process through the torch field
    ot = OnlineTaper(PG.musicbrainz_like(700, seed=12), 4, config=_tc("torch", source),
                     policy=_topology_policy(), device="cpu")
    replayed = replay_schedule(ot, schedule, backend="torch")
    return dict(schedule=[{k: v for k, v in m.items()
                           if k in ("kind", "version", "part", "redealt")}
                          for m in schedule],
                replayed=replayed, part=loop.part.copy(), version=int(g.version), m=g.m,
                deferred=deferred, invocations=loop.ot.invocations, stats=stats,
                served=sum(t.done.is_set() for t in tickets), tickets=len(tickets))


@pytest.mark.parametrize("n_ranks,source", [(2, "stripe"), (3, "partition")])
def test_ranks_agree_on_every_commit(n_ranks, source, tmp_path):
    """With the partition shard map every commit re-deals the ranks'
    shards along the new partition, and the replay follows rank 0's."""
    lead, *follow = run_ranks(_agree_rank, n_ranks, tmp_path, args=(source,))
    sched = lead["schedule"]
    commits = [m["part"] for m in sched if m["kind"] == "commit"]
    assert lead["invocations"] >= 2 and len(commits) == lead["invocations"]
    assert lead["served"] == lead["tickets"] and lead["stats"]["invocation_error"] == ""
    assert lead["deferred"]
    redeals = [m["redealt"] for m in sched if m["kind"] == "commit"]
    assert any(redeals) if source == "partition" else not any(redeals)
    kinds = [m["kind"] for m in sched]
    # the in-flight ingest went out after the first commit, before the next start
    assert kinds[:3] == ["start", "commit", "ingest"]
    assert np.array_equal(commits[-1], lead["part"])
    # the inline replay commits rank 0's partitions
    assert len(lead["replayed"]) == len(commits)
    assert all(np.array_equal(a, b) for a, b in zip(lead["replayed"], commits))
    for f in follow:
        assert f["error"] is None
        assert f["stats"]["commits"] == len(commits) and f["stats"]["aborts"] == 0
        assert all(np.array_equal(a, b) for a, b in zip(f["commits"], commits))
        assert np.array_equal(f["part"], lead["part"])
        assert (f["version"], f["m"]) == (lead["version"], lead["m"])
        # each message applied in rank 0's order, each ingest and start at
        # rank 0's graph version
        assert [t[0] for t in f["trace"]] == kinds
        for t, m in zip(f["trace"], sched):
            if m["kind"] in ("ingest", "start"):
                assert t[1] == m["version"]


# ---------------------------------------------------------------------------
# a follower's KernelError; a follower whose leader is gone
# ---------------------------------------------------------------------------


def _kernel_rank(rank, n_ranks):
    _deadline()
    g = PG.musicbrainz_like(600, seed=11)
    if rank:
        faults = FaultInjector()
        faults.arm(SITE_INVOCATION, exc=KernelError)
        return _follow(g, 4, None, _cfg(faults=faults))
    loop = ServingLoop(g, 4, taper_config=_tc(), config=_cfg(), device="cpu").start()
    tickets = [loop.submit(MQ1) for _ in range(40)]
    _until(lambda: all(t.done.is_set() for t in tickets), "the requests")
    err = None
    try:
        loop.stop()
    except KernelError as exc:
        err = str(exc)
    return dict(error=err, invocations=loop.ot.invocations,
                kinds=[m["kind"] for m in loop.schedule],
                served=sum(t.done.is_set() for t in tickets))


def test_follower_kernel_error_reaches_rank_0(tmp_path):
    lead, follow = run_ranks(_kernel_rank, 2, tmp_path)
    # rank 0 heard it at the run's start, stopped invoking, kept serving
    assert lead["error"] is not None and lead["error"].startswith("rank 1: KernelError")
    assert lead["invocations"] == 0 and lead["served"] == 40
    assert lead["kinds"] == ["start", "abort"]
    assert follow["error"].startswith("KernelError") and follow["commits"] == []


def _midrun_kernel_rank(rank, n_ranks, timeout_s):
    """Rank 1's plain ``vm_step`` raises ``KernelError`` at its second call
    inside a run: after the field's first collectives, while the other
    ranks go on to the next."""
    import repro_torch.core.visitor as visitor

    _deadline()
    g = PG.musicbrainz_like(600, seed=11)
    cfg = _cfg(stop_timeout_s=timeout_s)
    if rank:
        f = ShardFollower(g, 4, taper_config=_tc(), config=cfg, device="cpu")
        pre, step, seen = f.ot.taper._pre, visitor.vm_step_reference, {}

        def failing(*args, **kwargs):
            if "_before_collective" in pre:
                seen["calls"] = seen.get("calls", 0) + 1
                if seen["calls"] == 2:
                    seen["polls"] = f.agreement.collectives
                    raise KernelError("vm_step: injected launch failure")
            return step(*args, **kwargs)

        visitor.vm_step_reference = failing
        err = None
        try:
            f.run()
        except BaseException as exc:        # returned to the parent
            err = f"{type(exc).__name__}: {exc}"
        return dict(error=err, commits=len(f.commits), polls_at_failure=seen.get("polls"))
    loop = ServingLoop(g, 4, taper_config=_tc(), config=cfg, device="cpu").start()
    tickets = [loop.submit(MQ1) for _ in range(40)]
    _until(lambda: loop.invocation_in_flight or loop._kernel_error is not None, "the run")
    t0 = time.monotonic()
    _until(lambda: loop._kernel_error is not None, "the follower's error", wait_s=2 * timeout_s)
    heard_s = time.monotonic() - t0
    _until(lambda: all(t.done.is_set() for t in tickets), "the requests")
    err = None
    try:
        loop.stop()
    except KernelError as exc:
        err = str(exc)
    return dict(error=err, heard_s=heard_s, invocations=loop.ot.invocations,
                kinds=[m["kind"] for m in loop.schedule],
                served=sum(t.done.is_set() for t in tickets))


def test_follower_midrun_kernel_error_reaches_rank_0(tmp_path):
    """A follower that fails inside the field answers the others' next poll
    (before the field's next collective) with its failure: rank 0 hears
    the ``KernelError`` at once, well within ``stop_timeout_s``, and every
    rank leaves the run."""
    timeout_s = 20.0
    lead, follow = run_ranks(_midrun_kernel_rank, 2, tmp_path, args=(timeout_s,))
    # the failure came after the start's agreement and the field's first polls
    assert follow["polls_at_failure"] is not None and follow["polls_at_failure"] >= 3
    assert follow["error"].startswith("KernelError") and follow["commits"] == 0
    assert lead["error"] is not None and lead["error"].startswith("rank 1: KernelError")
    assert lead["heard_s"] < timeout_s / 2
    assert lead["invocations"] == 0 and lead["served"] == 40
    assert lead["kinds"] == ["start", "abort"]


def _silent_leader_rank(rank, n_ranks, timeout_s):
    import torch.distributed as dist

    _deadline()
    if rank == 0:
        ControlGroups(dist.group.WORLD, timeout_s)      # the follower's groups, then silence
        time.sleep(timeout_s + 4)
        return None
    g = PG.musicbrainz_like(300, seed=3)
    t0 = time.monotonic()
    out = _follow(g, 4, None, _cfg(stop_timeout_s=timeout_s))
    out["waited_s"] = time.monotonic() - t0
    return out


def test_follower_exits_when_its_leader_is_silent(tmp_path):
    timeout_s = 3.0
    _, follow = run_ranks(_silent_leader_rank, 2, tmp_path, args=(timeout_s,))
    assert follow["error"].startswith("TimeoutError")
    assert timeout_s <= follow["waited_s"] < timeout_s + 3.0


# ---------------------------------------------------------------------------
# threaded twins of the reference's loop tests
# ---------------------------------------------------------------------------


def _serves_rank(rank, n_ranks):
    _deadline()
    g = PG.musicbrainz_like(900, seed=9)
    if rank:
        return _follow(g, 4, None, _cfg(max_queue_depth=512))
    loop = ServingLoop(g, 4, taper_config=_tc(), config=_cfg(max_queue_depth=512),
                       device="cpu").start()
    tickets = []
    for i in range(60):
        t = loop.submit(MQ1 if i % 3 else MQ3)
        assert t.accepted
        tickets.append(t)
    loop.submit_mutations(MutationBatch(add_vertex_labels=[1], add_edges=[(g.n, 0), (g.n, 5)]))
    for t in tickets:
        assert t.wait(timeout=WAIT_S)
    stats = loop.stop()
    return dict(stats=stats, invocations=loop.ot.invocations, part=loop.part.copy(),
                n=g.n, version=int(g.version))


def test_threaded_loop_serves_and_invokes(tmp_path):
    lead, follow = run_ranks(_serves_rank, 2, tmp_path)
    stats = lead["stats"]
    assert stats["completed"] == 60 and lead["invocations"] >= 1
    part = lead["part"]
    assert part.shape == (lead["n"],) and ((part >= 0) & (part < 4)).all()
    for key in ("latency_p50_s", "latency_p99_s", "ipt_p99", "ipt_per_request",
                "queue_depth", "invocation_overlap_s", "invocation_stall_s",
                "partition_swaps"):
        assert key in stats
    assert stats["latency_p99_s"] >= stats["latency_p50_s"]
    assert stats["field_backend"] == "torch_sharded" and stats["invocation_error"] == ""
    assert follow["error"] is None and follow["stats"]["commits"] == lead["invocations"]
    assert np.array_equal(follow["part"], part) and follow["version"] == lead["version"]


def _warm_rank(rank, n_ranks):
    _deadline()
    g = PG.musicbrainz_like(700, seed=12)
    policy = OnlinePolicy(bootstrap_after_ticks=0, cadence=10 ** 9, dirty_fraction=2.0,
                          drift_l1=9e9)
    if rank:
        return _follow(g, 4, policy, _cfg())
    loop = ServingLoop(g, 4, taper_config=_tc(), policy=policy, config=_cfg(),
                       device="cpu").start()
    tickets = [loop.submit(MQ1) for _ in range(10)]
    sent = loop.schedule      # a commit goes out after its upload
    _until(lambda: all(t.done.is_set() for t in tickets)
           and [m["kind"] for m in sent] == ["start", "commit"], "the bootstrap invocation")
    ups = loop.ot.taper._pre["_shard_uploads"]
    total0 = ups["total_shards"]
    # a mutation local to the first shard's vertices: each rank re-uploads
    # its shard only if that shard is dirty
    loop.submit_mutations(MutationBatch(add_edges=[(0, 2), (1, 3)]))
    _until(lambda: len(sent) == 3 and ups["total_shards"] > total0, "the ingest's upload")
    uploaded = ups["total_shards"] - total0
    stats = loop.stop()
    return dict(rebuilds=ups["rebuilds"], uploaded=uploaded, stats=stats,
                invocations=loop.ot.invocations, version=int(g.version))


def test_sharded_warm_path_uploads_only_dirty_shards(tmp_path):
    lead, *follow = run_ranks(_warm_rank, 3, tmp_path)
    assert lead["invocations"] == 1 and lead["stats"]["upload_failures"] == 0
    uploaded = [lead["uploaded"]]
    for f in follow:
        assert f["error"] is None and f["version"] == lead["version"]
        assert f["trace"][-1][0] == "ingest"
        uploaded.append(f["trace"][-1][2] - f["trace"][-2][2])
        assert f["rebuilds"] == 1                   # patched in place, never re-packed
    assert lead["rebuilds"] == 1
    # each rank re-uploads only the dirty shard slices, not the packing
    assert all(1 <= u < 3 for u in uploaded)
