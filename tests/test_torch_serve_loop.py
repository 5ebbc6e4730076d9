"""The port's serving loop and engine facade against the JAX package's.

Twins of ``tests/test_serve_loop.py``'s loop tests and of
``tests/test_serve_engine.py``: the atomic partition swap under a
mid-invocation mutation, deferred ingest under an overlapped invocation,
the threaded loop end to end, the stop-the-world mode, the split-group
apply with its WAL, the engine facade; then the inline ``GraphQueryEngine``
of both packages over one request and mutation stream (every
``RequestResult``, each partition after an invocation and the
deterministic ``stats()`` counters equal), and the sharded warm path on a
one-rank gloo group and on 3 gloo ranks (``launch/mesh.py::run_ranks``),
each rank driving the inline loop over the same stream.  Everything runs
on the CPU (``device="cpu"``; the ``torch`` rung is bitwise the reference's
``jnp`` rung)."""
import threading

import numpy as np
import pytest

from repro.core.online import OnlinePolicy as ROnlinePolicy
from repro.core.online import OnlineTaper as ROnlineTaper
from repro.core.rpq import parse_rpq as r_parse
from repro.core.taper import TaperConfig as RTaperConfig
from repro.graphs import generators as RG
from repro.graphs.graph import MutationBatch as RMutationBatch
from repro.graphs.partition import hash_partition as r_hash
from repro.serve import GraphQueryEngine as RGraphQueryEngine
from repro.serve import ServeConfig as RServeConfig
from repro.serve import ServeLoopConfig as RServeLoopConfig
from repro.serve import ServingLoop as RServingLoop
from repro.serve.snapshot import WAL_NAME as R_WAL_NAME
from repro_torch.core.online import OnlinePolicy, OnlineTaper
from repro_torch.core.rpq import parse_rpq
from repro_torch.core.taper import FIELD_BACKEND_LADDER, TaperConfig
from repro_torch.graphs import generators as PG
from repro_torch.graphs.graph import MutationBatch
from repro_torch.graphs.partition import hash_partition
from repro_torch.launch.mesh import run_ranks
from repro_torch.serve import (GraphQueryEngine, ServeConfig, ServeLoopConfig,
                               ServingLoop)
from repro_torch.serve.snapshot import WAL_NAME, MutationJournal
from repro_torch.workload.stream import GraphMutationStream

MQ_TEXT = ["Area.Artist.(Artist|Label).Area",
           "Artist.Credit.(Track|Recording).Credit.Artist",
           "Artist.Credit.Track.Medium"]
MQ1, MQ3 = parse_rpq(MQ_TEXT[0]), parse_rpq(MQ_TEXT[2])
R_MQ1, R_MQ3 = r_parse(MQ_TEXT[0]), r_parse(MQ_TEXT[2])
#: the longest any threaded test waits on one event
WAIT_S = 30.0


def _graphs_equal(g1, g2):
    assert g1.n == g2.n and g1.version == g2.version
    for a in ("labels", "src", "dst", "row_ptr"):
        assert np.array_equal(getattr(g1, a), getattr(g2, a)), a


# ---------------------------------------------------------------------------
# atomic partition swap (double buffering) under a mid-invocation mutation
# ---------------------------------------------------------------------------


def test_commit_grafts_snapshot_onto_grown_partition():
    outs = []
    for gen, online, policy, tc, batch, q1, q3, kw in (
            (PG, OnlineTaper, OnlinePolicy, TaperConfig, MutationBatch, MQ1, MQ3,
             {"device": "cpu"}),
            (RG, ROnlineTaper, ROnlinePolicy, RTaperConfig, RMutationBatch, R_MQ1, R_MQ3, {})):
        g = gen.musicbrainz_like(900, seed=3)
        ot = online(g, 4, policy=policy(), config=tc(max_iterations=2), **kw)
        ot.observe([q1, q3] * 30)
        n0 = g.n
        pending = ot.begin_invocation("manual")
        assert pending is not None and pending.n_snapshot == n0
        old_part = ot.part
        rep = ot.run_invocation(pending)
        applied = ot.apply_mutations(batch(add_vertex_labels=[0, 1],
                                           add_edges=[(n0, 0), (n0 + 1, 2), (3, 4)]))
        tail = ot.part[n0:].copy()
        ot.commit_invocation(pending)
        assert ot.part.shape == (n0 + 2,)
        assert np.array_equal(ot.part[:n0], rep.final_part[:n0])
        assert np.array_equal(ot.part[n0:], tail)
        assert ot.invocations == 1 and old_part.shape == (n0,)
        dirty = applied.dirty_vertices()
        assert ot._dirty[dirty[dirty < ot._dirty.shape[0]]].any()
        outs.append((ot.part.copy(), ot._dirty.copy(), rep.total_moves))
    assert np.array_equal(outs[0][0], outs[1][0]) and np.array_equal(outs[0][1], outs[1][1])
    assert outs[0][2] == outs[1][2]


def _gate_invocations(loop):
    """Hold every overlapped run at its start until the returned event is
    set, so a test sees the run in flight whatever the threads' timing."""
    release = threading.Event()
    run = loop.ot.run_invocation

    def gated(pending, should_abort=None):
        assert release.wait(WAIT_S), "the test never released the invocation"
        return run(pending, should_abort=should_abort)

    loop.ot.run_invocation = gated
    return release


def _defer_ingest(loop_cls, gen, policy, tc, cfg, batch, q1, kw):
    g = gen.musicbrainz_like(700, seed=5)
    loop = loop_cls(g, 4, taper_config=tc(max_iterations=2),
                    policy=policy(bootstrap_after_ticks=0, cadence=10 ** 9,
                                  dirty_fraction=2.0, drift_l1=9e9),
                    config=cfg(micro_batch=8, overlap_invocations=True), **kw)
    release = _gate_invocations(loop)
    for _ in range(8):
        loop.submit(q1)
    n0 = g.n
    loop.pump()
    assert loop.invocation_in_flight
    loop.submit_mutations(batch(add_vertex_labels=[0], add_edges=[(n0, 1)]))
    assert g.n == n0
    release.set()
    loop._finish_inflight()
    assert not loop.invocation_in_flight and loop.ot.invocations == 1 and g.n == n0
    loop.pump()
    assert g.n == n0 + 1 and loop.part.shape == (n0 + 1,)
    loop.stop()
    return loop.part.copy()


def test_overlapped_loop_defers_ingest_until_commit():
    port = _defer_ingest(ServingLoop, PG, OnlinePolicy, TaperConfig, ServeLoopConfig,
                         MutationBatch, MQ1, {"device": "cpu"})
    ref = _defer_ingest(RServingLoop, RG, ROnlinePolicy, RTaperConfig, RServeLoopConfig,
                        RMutationBatch, R_MQ1, {})
    assert np.array_equal(port, ref)


# ---------------------------------------------------------------------------
# the threaded loop end to end
# ---------------------------------------------------------------------------


def test_threaded_loop_serves_and_invokes():
    g = PG.musicbrainz_like(900, seed=9)
    loop = ServingLoop(g, 4, taper_config=TaperConfig(max_iterations=2),
                       config=ServeLoopConfig(micro_batch=8, max_queue_depth=512,
                                              batch_wait_s=0.002),
                       device="cpu").start()
    tickets = []
    for i in range(60):
        t = loop.submit(MQ1 if i % 3 else MQ3)
        assert t.accepted
        tickets.append(t)
    loop.submit_mutations(MutationBatch(add_vertex_labels=[1], add_edges=[(g.n, 0), (g.n, 5)]))
    for t in tickets:
        assert t.wait(timeout=30.0)
    stats = loop.stop()
    assert stats["completed"] == 60 and loop.ot.invocations >= 1
    assert loop.part.shape == (g.n,) and ((loop.part >= 0) & (loop.part < 4)).all()
    for key in ("latency_p50_s", "latency_p99_s", "ipt_p99", "ipt_per_request",
                "queue_depth", "invocation_overlap_s", "invocation_stall_s",
                "partition_swaps"):
        assert key in stats
    assert stats["latency_p99_s"] >= stats["latency_p50_s"]
    assert stats["field_backend"] == "torch" and stats["invocation_error"] == ""


def test_malformed_ingest_batch_does_not_kill_the_loop():
    g = PG.musicbrainz_like(500, seed=15)
    loop = ServingLoop(g, 4, taper_config=TaperConfig(max_iterations=2),
                       config=ServeLoopConfig(micro_batch=8), device="cpu").start()
    m0 = g.m
    w = next(v for v in range(1, g.n) if v not in set(g.neighbors(0).tolist()))
    loop.submit_mutations(MutationBatch(add_edges=[(0, w)]))
    loop.submit_mutations(MutationBatch(relabel=[(g.n + 5, 0)]))
    tickets = [loop.submit(MQ1) for _ in range(10)]
    for t in tickets:
        assert t.wait(timeout=30.0)
    stats = loop.stop()
    assert stats["completed"] == 10 and stats["failed_mutations"] == 1
    assert g.m == m0 + 2


def _stop_the_world(loop_cls, gen, tc, cfg, q1, kw):
    loop = loop_cls(gen.musicbrainz_like(600, seed=11), 4, taper_config=tc(max_iterations=2),
                    config=cfg(micro_batch=8, overlap_invocations=False), **kw)
    tickets = [loop.submit(q1) for _ in range(10)]
    while not all(t.done.is_set() for t in tickets):
        loop.pump()
    stats = loop.stop()
    assert loop.ot.invocations >= 1
    assert stats["invocation_stall_s"] > 0 and stats["invocation_overlap_s"] == 0.0
    return loop.part.copy(), [(t.ipt, t.paths) for t in tickets], loop.ot.invocations


def test_stop_the_world_mode_records_stalls():
    port = _stop_the_world(ServingLoop, PG, TaperConfig, ServeLoopConfig, MQ1, {"device": "cpu"})
    ref = _stop_the_world(RServingLoop, RG, RTaperConfig, RServeLoopConfig, R_MQ1, {})
    assert np.array_equal(port[0], ref[0]) and port[1:] == ref[1:]


# ---------------------------------------------------------------------------
# the sharded warm path: one gloo rank here, then 3 spawned ranks
# ---------------------------------------------------------------------------


def _sharded_loop_run(n_stream_requests=10):
    """The inline sharded loop of the reference test: a bootstrap
    invocation through ``torch_sharded``, then a mutation local to the first
    vertices; returns the shard uploads before and after it, the partition
    and the loop's stats."""
    g = PG.musicbrainz_like(700, seed=12)
    loop = ServingLoop(
        g, 4, taper_config=TaperConfig(max_iterations=2, field_backend="torch_sharded"),
        policy=OnlinePolicy(bootstrap_after_ticks=0, cadence=10 ** 9, dirty_fraction=2.0,
                            drift_l1=9e9),
        config=ServeLoopConfig(micro_batch=8, overlap_invocations=False), device="cpu")
    tickets = [loop.submit(MQ1) for _ in range(n_stream_requests)]
    while not all(t.done.is_set() for t in tickets):
        loop.pump()
    assert loop.ot.invocations == 1
    ups = loop.ot.taper._pre["_shard_uploads"]
    total0, part0 = ups["total_shards"], loop.part.copy()
    loop.submit_mutations(MutationBatch(add_edges=[(0, 2), (1, 3)]))
    loop.pump()
    out = dict(rebuilds=ups["rebuilds"], uploaded=ups["total_shards"] - total0,
               part=part0, paths=[(t.ipt, t.paths) for t in tickets],
               version=g.version, stats=loop.stop())
    return out


def _sharded_rank(rank, n_ranks):
    import torch.distributed as dist

    out = _sharded_loop_run()
    out["world"] = dist.get_world_size()
    return out


def _plain_loop_partition():
    """The same stream through the single-device ``torch`` field."""
    g = PG.musicbrainz_like(700, seed=12)
    loop = ServingLoop(
        g, 4, taper_config=TaperConfig(max_iterations=2, field_backend="torch"),
        policy=OnlinePolicy(bootstrap_after_ticks=0, cadence=10 ** 9, dirty_fraction=2.0,
                            drift_l1=9e9),
        config=ServeLoopConfig(micro_batch=8, overlap_invocations=False), device="cpu")
    tickets = [loop.submit(MQ1) for _ in range(10)]
    while not all(t.done.is_set() for t in tickets):
        loop.pump()
    loop.stop()
    return loop.part.copy(), [(t.ipt, t.paths) for t in tickets]


def test_sharded_warm_path_uploads_only_dirty_shards():
    out = _sharded_loop_run()
    assert out["rebuilds"] == 1 and out["uploaded"] >= 1      # one rank: S = 1
    assert out["stats"]["field_backend"] == "torch_sharded"
    assert out["stats"]["upload_failures"] == 0
    part, paths = _plain_loop_partition()
    # the sharded field is bitwise the torch field: the same invocation
    assert np.array_equal(out["part"], part) and out["paths"] == paths


def test_sharded_warm_path_on_three_ranks(tmp_path):
    ranks = run_ranks(_sharded_rank, 3, tmp_path)
    part, paths = _plain_loop_partition()
    for out in ranks:
        assert out["world"] == 3
        assert out["rebuilds"] == 1                 # patched in place, not re-packed
        assert 1 <= out["uploaded"] < 3             # only the dirty shards
        assert np.array_equal(out["part"], part) and out["paths"] == paths
        assert out["version"] == ranks[0]["version"]


# ---------------------------------------------------------------------------
# the engine facade
# ---------------------------------------------------------------------------


def _first_invocation_after(eng_cls, cfg_cls, gen, hashp, q1, kw):
    g = gen.musicbrainz_like(600, seed=14)
    eng = eng_cls(g, hashp(g.n, 4, seed=1), 4,
                  cfg_cls(first_invocation_after=15, max_results_per_query=4), **kw)
    out = eng.serve_batch([q1] * 10)
    assert eng.invocations == 0
    out += eng.serve_batch([q1] * 10)
    assert eng.invocations == 1
    return [(r.query, r.n_results, r.ipt) for r in out], eng.part.tolist()


def test_first_invocation_after_gates_bootstrap():
    assert _first_invocation_after(GraphQueryEngine, ServeConfig, PG, hash_partition, MQ1,
                                   {"device": "cpu"}) == \
        _first_invocation_after(RGraphQueryEngine, RServeConfig, RG, r_hash, R_MQ1, {})


def _facade(eng_cls, cfg_cls, gen, hashp, batch, q1, q3, kw):
    g = gen.musicbrainz_like(600, seed=13)
    eng = eng_cls(g, hashp(g.n, 4, seed=1), 4,
                  cfg_cls(min_requests_between_invocations=20, max_results_per_query=4), **kw)
    out = eng.serve_batch([q1] * 10)
    n0 = g.n
    eng.apply_mutations(batch(add_vertex_labels=[2], add_edges=[(n0, 1)]))
    out += eng.serve_batch([q3] * 10)
    assert g.n == n0 + 1 and eng.part.shape == (n0 + 1,)
    s = eng.stats()
    assert s["requests"] == 20 and s["invocations"] >= 1
    assert "ipt_p99" in s and "latency_p99_s" in s
    return [(r.query, r.n_results, r.ipt) for r in out], eng.part.tolist(), s["invocations"]


def test_facade_engine_routes_mutations_and_stats():
    assert _facade(GraphQueryEngine, ServeConfig, PG, hash_partition, MutationBatch,
                   MQ1, MQ3, {"device": "cpu"}) == \
        _facade(RGraphQueryEngine, RServeConfig, RG, r_hash, RMutationBatch, R_MQ1, R_MQ3, {})


@pytest.fixture(scope="module")
def engines():
    """tests/test_serve_engine.py's engine, one of each package."""
    def make(eng_cls, cfg_cls, gen, hashp, kw):
        g = gen.provgen_like(2000, seed=4)
        return eng_cls(g, hashp(g.n, 4, seed=1), 4,
                       cfg_cls(min_requests_between_invocations=50, drift_threshold=0.2,
                               max_results_per_query=8), **kw)
    return (make(GraphQueryEngine, ServeConfig, PG, hash_partition, {"device": "cpu"}),
            make(RGraphQueryEngine, RServeConfig, RG, r_hash, {}))


def _results(out):
    return [(r.query, r.n_results, r.ipt) for r in out]


def test_serve_batch_returns_results(engines):
    eng, ref = engines
    q = parse_rpq("Entity.Activity")
    out = eng.serve_batch([q, q, q])
    assert len(out) == 3
    assert all(r.n_results >= 0 and r.ipt >= 0 and r.latency_s >= 0 for r in out)
    assert _results(out) == _results(ref.serve_batch([r_parse("Entity.Activity")] * 3))


def test_drift_triggers_invocation(engines):
    eng, ref = engines
    for e, parse in ((eng, parse_rpq), (ref, r_parse)):
        qa, qb = parse("Entity.Entity"), parse("Agent.Activity")
        for _ in range(3):
            e.serve_batch([qa] * 30)
        inv1 = e.invocations
        assert inv1 >= 1
        part1 = e.part.copy()
        for _ in range(4):
            e.serve_batch([qb] * 30)
        assert e.invocations > inv1 and (e.part != part1).any()
        assert e.part.min() >= 0 and e.part.max() < 4
    assert eng.invocations == ref.invocations and np.array_equal(eng.part, ref.part)


def test_stats_accounting(engines):
    eng, ref = engines
    s = eng.stats()
    assert s["requests"] > 0 and s["ipt_per_request"] >= 0
    r = ref.stats()
    for key in ("requests", "invocations", "total_ipt", "ipt_per_request", "drift",
                "partition_swaps", "enum_sweeps", "frontier_rows"):
        assert s[key] == r[key], key


# ---------------------------------------------------------------------------
# the inline engine of both packages over one stream
# ---------------------------------------------------------------------------

#: stats() counters that do not depend on the clock
DETERMINISTIC = ("completed", "batches", "rejected_requests", "rejected_mutations",
                 "failed_mutations", "total_ipt", "ipt_per_request", "ipt_p50", "ipt_p99",
                 "invocations", "invocation_failures", "partition_swaps", "enum_sweeps",
                 "frontier_rows", "backend_fallbacks", "backend_recoveries",
                 "journal_seq", "healthy", "degraded", "requests", "drift")


def _engine_stream(eng_cls, cfg_cls, tc_cls, gen, hashp, batch_cls, parse, kw):
    g = gen.musicbrainz_like(2000, avg_degree=6.0, seed=13)
    muts = GraphMutationStream("mixed", seed=7, vertices_per_tick=4, edges_per_tick=16)
    scratch, batches = PG.musicbrainz_like(2000, avg_degree=6.0, seed=13), []
    for _ in range(2):
        b = muts.next_batch(scratch)
        scratch.apply_mutations(b)
        batches.append(batch_cls(**{k: getattr(b, k) for k in (
            "add_vertex_labels", "add_edges", "remove_edges", "remove_vertices", "relabel")}))
    eng = eng_cls(g, hashp(g.n, 8, seed=1), 8,
                  cfg_cls(min_requests_between_invocations=50, drift_threshold=0.2,
                          max_results_per_query=8, taper=tc_cls(max_iterations=4, seed=0)),
                  **kw)
    queries = [parse(q) for q in MQ_TEXT]
    rng = np.random.default_rng(5)
    results, parts = [], []
    for r in range(8):
        if r in (2, 5):
            eng.apply_mutations(batches.pop(0))
        mix = (0.6, 0.3, 0.1) if r < 4 else (0.1, 0.2, 0.7)
        inv0 = eng.invocations
        out = eng.serve_batch([queries[i] for i in rng.choice(3, 30, p=mix)])
        results += _results(out)
        if eng.invocations != inv0:
            parts.append(eng.part.copy())
    s = eng.stats()
    return results, parts, {k: s[k] for k in DETERMINISTIC}, g


def test_inline_engines_agree_over_one_stream():
    results, parts, stats, g = _engine_stream(
        GraphQueryEngine, ServeConfig, TaperConfig, PG, hash_partition, MutationBatch,
        parse_rpq, {"device": "cpu"})
    r_results, r_parts, r_stats, rg = _engine_stream(
        RGraphQueryEngine, RServeConfig, RTaperConfig, RG, r_hash, RMutationBatch,
        r_parse, {})
    assert results == r_results
    assert len(parts) == len(r_parts) >= 2
    assert all(np.array_equal(a, b) for a, b in zip(parts, r_parts))
    assert stats == r_stats
    _graphs_equal(g, rg)


def test_field_backend_ladder_rungs():
    assert FIELD_BACKEND_LADDER == ("cuda_sharded", "cuda", "torch")
    # None resolves to its device's rung when the loop is built
    loop = ServingLoop(PG.musicbrainz_like(200, seed=1), 4, device="cpu")
    assert loop.ot.taper.config.field_backend == "torch" and not loop.degraded
    assert loop._base_backend == "torch"
    loop.stop()
    with pytest.raises(ValueError, match="unknown field backend"):
        loop.ot.taper.set_field_backend("jnp")


# ---------------------------------------------------------------------------
# the split-group apply and its WAL
# ---------------------------------------------------------------------------


def _split_groups(loop_cls, gen, cfg, batch, wal_name, tmp_path, kw):
    g = gen.musicbrainz_like(300, seed=31)
    ref = g.copy()
    loop = loop_cls(g, 4, config=cfg(micro_batch=8, overlap_invocations=False,
                                     snapshot_dir=str(tmp_path)), **kw)
    v0 = g.version
    batches = [batch(remove_vertices=[5]), batch(add_edges=[(5, 11)])]
    for b in batches:
        assert loop.submit_mutations(b) is True
    loop.pump()
    assert g.version == v0 + 2 and loop.ingest.applied_batches == 2
    assert 11 in g.neighbors(5)
    for b in batches:
        ref.apply_mutations(b)
    _graphs_equal(g, ref)
    loop.stop()
    return (tmp_path / wal_name).read_bytes()


def test_loop_applies_split_groups_and_journals_both(tmp_path):
    wal = _split_groups(ServingLoop, PG, ServeLoopConfig, MutationBatch, WAL_NAME,
                        tmp_path / "port", {"device": "cpu"})
    out = MutationJournal(tmp_path / "port" / WAL_NAME).replay()
    assert [seq for seq, _, _ in out] == [1, 2]
    assert all(o["mode"] == "merged" for _, _, o in out)
    assert len(out[0][1]) == 1 and len(out[1][1]) == 1
    # the reference's WAL of the same stream, byte for byte
    assert wal == _split_groups(RServingLoop, RG, RServeLoopConfig, RMutationBatch,
                                R_WAL_NAME, tmp_path / "ref", {})
