"""The port's online slice against the JAX reference.

``FrequencySketch``, ``WorkloadStream`` and ``GraphMutationStream`` give the
reference's frequencies and batches; the executor's traversal-count patch
across single, multi-record and compacted mutation spans equals both the
reference's patch and a rebuild; ``Taper.invoke(frontier=...)`` and an
``OnlineTaper`` trace (the ``begin``/``run``/``commit_invocation`` split,
and a driver built from ``convert``'s carried graph, log and sketch) equal
the reference's with its ``jnp`` field bitwise.  The port's twins of
``tests/test_online_taper.py``, ``test_sketch.py`` and
``test_property_dynamic.py`` follow."""
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

torch.set_num_threads(1)

from repro.core.online import OnlinePolicy as ROnlinePolicy
from repro.core.online import OnlineTaper as ROnlineTaper
from repro.core.rpq import parse_rpq as r_parse
from repro.core.taper import InvocationAborted as RInvocationAborted
from repro.core.taper import Taper as RTaper
from repro.core.taper import TaperConfig as RTaperConfig
from repro.graphs import generators as rgen
from repro.graphs.graph import MutationBatch as RMutationBatch
from repro.graphs.graph import mutation_log_state as r_log_state
from repro.graphs.partition import fennel_stream_partition as r_fennel
from repro.workload.executor import QueryExecutor as RQueryExecutor
from repro.workload.sketch import FrequencySketch as RFrequencySketch
from repro.workload.stream import GraphMutationStream as RGraphMutationStream
from repro.workload.stream import WorkloadStream as RWorkloadStream
from repro.workload.stream import linear_drift as r_linear_drift
from repro.workload.stream import periodic_frequencies as r_periodic

from repro_torch.convert import from_reference_arrays
from repro_torch.core.online import OnlinePolicy, OnlineTaper
from repro_torch.core.rpq import parse_rpq
from repro_torch.core.swap import SwapConfig, swap_iteration
from repro_torch.core.taper import InvocationAborted, Taper, TaperConfig
from repro_torch.core.tpstry import TPSTry
from repro_torch.core.visitor import extroversion_field
from repro_torch.graphs.generators import musicbrainz_like, power_law_labelled
from repro_torch.graphs.graph import MutationBatch
from repro_torch.graphs.metrics import partition_balance
from repro_torch.graphs.partition import fennel_stream_partition, hash_partition
from repro_torch.workload.executor import QueryExecutor, ipt_of_partition
from repro_torch.workload.sketch import FrequencySketch
from repro_torch.workload.stream import (GraphMutationStream, WorkloadStream,
                                         linear_drift, periodic_frequencies)
from test_torch_dynamic_graph import (  # same-directory sibling
    _assert_full_parity, _random_spec, _seed_caches)

MQ_TEXT = ["Area.Artist.(Artist|Label).Area",
           "Artist.Credit.(Track|Recording).Credit.Artist",
           "Artist.Credit.Track.Medium"]
MQ1 = parse_rpq(MQ_TEXT[0])
MQ3 = parse_rpq(MQ_TEXT[2])
CPU = "cpu"


def _workload():
    return [(MQ1, 0.5), (MQ3, 0.5)]


def _pair(gen, n, seed, **kw):
    rg = getattr(rgen, gen)(n, seed=seed, **kw)
    g = from_reference_arrays(graph=dict(
        n=rg.n, labels=rg.labels, label_names=rg.label_names, src=rg.src,
        dst=rg.dst)).graph
    return g, rg


def _batch_dict(b):
    return dict(add_vertex_labels=np.asarray(b.add_vertex_labels),
                add_edges=np.asarray(b.add_edges),
                remove_edges=np.asarray(b.remove_edges),
                remove_vertices=np.asarray(b.remove_vertices),
                relabel=np.asarray(b.relabel))


def _same_batch(b, rb):
    for (k, v), rv in zip(_batch_dict(b).items(), _batch_dict(rb).values()):
        assert v.shape == rv.shape and np.array_equal(v, rv), k


def _fwd(g):
    und = np.stack([g.src, g.dst], 1)
    return und[und[:, 0] < und[:, 1]]


# ---------------------------------------------------------------------------
# sketch and streams against the reference
# ---------------------------------------------------------------------------


def test_sketch_equals_reference_over_ticks():
    sk, rsk = FrequencySketch(half_life=3.0), RFrequencySketch(half_life=3.0)
    qs = [parse_rpq(t) for t in MQ_TEXT]
    rqs = [r_parse(t) for t in MQ_TEXT]
    rng = np.random.default_rng(0)
    for tick in range(12):
        idx = rng.integers(0, 3, int(rng.integers(0, 40)))
        sk.observe_batch([qs[i] for i in idx])
        rsk.observe_batch([rqs[i] for i in idx])
        if tick % 4 == 3:
            sk.observe(qs[1], 2.5)
            rsk.observe(rqs[1], 2.5)
        assert sk.frequencies() == rsk.frequencies()
        assert sk.counts == rsk.counts and sk._stamp == rsk._stamp
        assert [(q.qhash, f) for q, f in sk.workload(0.1)] == [
            (q.qhash, f) for q, f in rsk.workload(0.1)]
    carried = from_reference_arrays(sketch=rsk.state_dict()).sketch
    assert carried.frequencies() == rsk.frequencies()
    assert carried.state_dict() == rsk.state_dict()


@pytest.mark.parametrize("mode", ["periodic", "linear", "static"])
def test_workload_stream_equals_reference(mode):
    texts = MQ_TEXT[:2] if mode == "linear" else MQ_TEXT
    kw = dict(period=5.0, mode=mode, static_freqs=(1.0, 2.0, 3.0)[:len(texts)],
              seed=4)
    ws = WorkloadStream([parse_rpq(t) for t in texts], **kw)
    rws = RWorkloadStream([r_parse(t) for t in texts], **kw)
    for _ in range(6):
        ws.advance(0.7)
        rws.advance(0.7)
        assert np.array_equal(ws.frequencies(), rws.frequencies())
        assert [q.qhash for q in ws.sample(50)] == [q.qhash for q in rws.sample(50)]
    assert np.array_equal(periodic_frequencies(4, 0.3, 2.0), r_periodic(4, 0.3, 2.0))
    assert np.array_equal(linear_drift(0.25), r_linear_drift(0.25))


@pytest.mark.parametrize("mode", ["grow", "churn", "burst", "mixed"])
def test_mutation_stream_equals_reference(mode):
    g, rg = _pair("musicbrainz_like", 700, 3)
    kw = dict(mode=mode, vertices_per_tick=3, edges_per_tick=9, burst_every=2,
              burst_scale=3, seed=11)
    s, rs = GraphMutationStream(**kw), RGraphMutationStream(**kw)
    for _ in range(5):
        b, rb = s.next_batch(g), rs.next_batch(rg)
        _same_batch(b, rb)
        g.apply_mutations(b)
        rg.apply_mutations(rb)
        assert np.array_equal(g.src, rg.src) and np.array_equal(g.labels, rg.labels)


def test_fennel_equals_reference():
    g, rg = _pair("musicbrainz_like", 900, 4)
    for k, seed in ((4, 0), (8, 3)):
        assert np.array_equal(fennel_stream_partition(g, k, seed=seed),
                              r_fennel(rg, k, seed=seed))


# ---------------------------------------------------------------------------
# the executor's patch against the reference's and a rebuild
# ---------------------------------------------------------------------------


def _executor_pair(n, seed, text):
    g, rg = _pair("musicbrainz_like", n, seed)
    q, rq = parse_rpq(text), r_parse(text)
    ex, rex = QueryExecutor(g), RQueryExecutor(rg)
    ex.traversals(q)
    rex.traversals(rq)
    return g, rg, q, rq, ex, rex


def _mutate_both(g, rg, rng):
    spec = _random_spec(g, rng, nv=2, na=8, nr=5, rem_v=[], nrl=1)
    g.apply_mutations(MutationBatch(**spec))
    rg.apply_mutations(RMutationBatch(**spec))


@pytest.mark.parametrize("gap", [1, 3, 20], ids=["one", "multi", "compacted"])
def test_executor_patch_equals_reference_and_rebuild(gap):
    g, rg, q, rq, ex, rex = _executor_pair(900, 5, MQ_TEXT[0])
    rng = np.random.default_rng(gap)
    for _ in range(gap):
        _mutate_both(g, rg, rng)
    assert len(g.mutation_log) == min(gap, g.MUTATION_LOG_LIMIT)
    assert ex._covering_mutations(0) is not None
    stale = ex._cache[q.qhash]
    patched = ex._patch(stale)
    r_patched = rex._patch(rex._cache[rq.qhash])
    assert patched is not None and r_patched is not None
    assert np.array_equal(patched.trav, r_patched.trav)
    assert np.array_equal(patched.cnt, r_patched.cnt)
    assert patched.depth1 == r_patched.depth1 and patched.steps == r_patched.steps
    fresh = QueryExecutor(g)
    assert np.array_equal(ex.traversals(q), fresh.traversals(q))
    assert np.array_equal(ex._cache[q.qhash].cnt, fresh._cache[q.qhash].cnt)
    assert ex.collect() == {"count_cache_size": 1}


def test_executor_version_inside_compacted_span_rebuilds():
    g, rg, q, rq, ex, rex = _executor_pair(700, 7, MQ_TEXT[2])
    rng = np.random.default_rng(9)
    _mutate_both(g, rg, rng)
    ex, rex = QueryExecutor(g), RQueryExecutor(rg)
    ex.traversals(q)                          # snapshot at version 1
    rex.traversals(rq)
    for _ in range(g.MUTATION_LOG_LIMIT + 2):
        _mutate_both(g, rg, rng)
    assert ex._covering_mutations(1) is None and rex._covering_mutations(1) is None
    assert ex._patch(ex._cache[q.qhash]) is None
    assert np.array_equal(ex.traversals(q), rex.traversals(rq))
    part = hash_partition(g.n, 4, seed=1)
    assert ipt_of_partition(g, [(q, 1.0)], part, ex) == rex.workload_ipt(
        [(rq, 1.0)], part)


def test_carried_log_patches_executor_state():
    """An executor's counts taken at version 0 patch across the mutation
    log that convert carried over from the reference graph, as the
    reference's executor patches across its own log."""
    g0, rg, q, rq, ex, rex = _executor_pair(800, 6, MQ_TEXT[1])
    rng = np.random.default_rng(4)
    for _ in range(4):
        spec = dict(add_vertex_labels=rng.integers(0, rg.n_labels, 2),
                    add_edges=np.stack([rng.integers(0, rg.n + 2, 10),
                                        rng.integers(0, rg.n + 2, 10)], 1),
                    remove_edges=_fwd(rg)[rng.choice(len(_fwd(rg)), 6, replace=False)],
                    relabel=[(int(rng.integers(0, rg.n)), 1)])
        rg.apply_mutations(RMutationBatch(**spec))
    g = from_reference_arrays(graph=dict(
        n=rg.n, labels=rg.labels, label_names=rg.label_names, src=rg.src,
        dst=rg.dst, version=rg.version,
        mutation_log=r_log_state(rg.mutation_log))).graph
    ex.g = g                        # the executor's state is at version 0
    patched = ex._patch(ex._cache[q.qhash])
    r_patched = rex._patch(rex._cache[rq.qhash])
    assert patched is not None and patched.version == g.version == 4
    assert np.array_equal(patched.trav, r_patched.trav)
    assert np.array_equal(patched.cnt, r_patched.cnt)
    assert np.array_equal(ex.traversals(q), QueryExecutor(g).traversals(q))


# ---------------------------------------------------------------------------
# frontier invocations and aborts against the reference
# ---------------------------------------------------------------------------


def test_invoke_frontier_equals_reference():
    g, rg = _pair("musicbrainz_like", 1200, 4)
    w = [(parse_rpq(t), f) for t, f in zip(MQ_TEXT, (0.2, 0.3, 0.5))]
    rw = [(r_parse(t), f) for t, f in zip(MQ_TEXT, (0.2, 0.3, 0.5))]
    part = hash_partition(g.n, 4, seed=1)
    frontier = np.arange(0, g.n, 9)
    rep = Taper(g, 4, TaperConfig(max_iterations=3), device=CPU).invoke(
        part, w, frontier=frontier)
    rrep = RTaper(rg, 4, RTaperConfig(max_iterations=3)).invoke(
        part, rw, frontier=frontier)
    assert rep.iterations == rrep.iterations and rep.moves == rrep.moves
    for a, b in zip(rep.parts, rrep.parts):
        assert np.array_equal(a, b)
    assert rep.objective == rrep.objective
    # the frontier restricts the first iteration's moves to its 1-hop
    # neighbourhood (families drag at most one hop further)
    mask = Taper(g, 4, device=CPU)._frontier_mask(frontier)
    moved = np.nonzero(rep.parts[1] != rep.parts[0])[0]
    assert all(mask[v] or mask[g.neighbors(v)].any() for v in moved)


def test_should_abort_raises_before_start_and_at_iteration():
    g = musicbrainz_like(600, seed=2)
    part = hash_partition(g.n, 4, seed=1)
    taper = Taper(g, 4, TaperConfig(max_iterations=4), device=CPU)
    with pytest.raises(InvocationAborted, match="before start"):
        taper.invoke(part, _workload(), should_abort=lambda: True)
    calls = []

    def abort_second():
        calls.append(1)
        return len(calls) >= 3          # before start, iteration 1, then 2

    with pytest.raises(InvocationAborted, match="at iteration 2"):
        taper.invoke(part, _workload(), should_abort=abort_second)
    assert issubclass(InvocationAborted, RuntimeError)
    assert InvocationAborted.__name__ == RInvocationAborted.__name__


def test_taper_sync_graph_refreshes_counts_and_memo():
    g = musicbrainz_like(500, seed=3)
    taper = Taper(g, 4, device=CPU)
    part = hash_partition(g.n, 4, seed=1)
    arrays = TPSTry.from_workload(_workload()).compile(g.label_names)
    f0 = taper.field(part, arrays)
    assert taper.field(part, arrays) is f0          # memo hit
    g.apply_mutations(MutationBatch(add_edges=[(0, 499), (1, 498)]))
    f1 = taper.field(part, arrays)
    assert f1 is not f0 and taper._pre["cnt"] is g.cached_neighbor_label_counts()
    fresh = extroversion_field(g.copy(), arrays, part, 4, device=CPU)
    for name in ("alpha", "edge_mass", "ext_to"):
        assert np.array_equal(getattr(f1, name), getattr(fresh, name))


# ---------------------------------------------------------------------------
# OnlineTaper traces against the reference
# ---------------------------------------------------------------------------


def _trace(ot, rot, g, rg, ticks, ws, rws, ms, rms, ex, rex, split=False):
    qs = [q for q, _ in ws.workload()]
    rqs = [q for q, _ in rws.workload()]
    for _ in range(ticks):
        ws.advance(1.0)
        rws.advance(1.0)
        ot.observe(ws.sample(80))
        rot.observe(rws.sample(80))
        b, rb = ms.next_batch(g), rms.next_batch(rg)
        _same_batch(b, rb)
        a, ra = ot.apply_mutations(b), rot.apply_mutations(rb)
        assert a.version == ra.version
        assert np.array_equal(ot.part, rot.part)
        w = ws.workload()
        ipt = ex.workload_ipt(w, ot.part)
        assert ipt == rex.workload_ipt(rws.workload(), rot.part)
        if split:
            dirty_before = int(ot._dirty.sum())
            r_dirty_before = int(rot._dirty.sum())
            reason, r_reason = ot.poll(measured_ipt=ipt), rot.poll(measured_ipt=ipt)
            pend = r_pend = None
            if reason is not None:
                pend, r_pend = ot.begin_invocation(reason), rot.begin_invocation(r_reason)
            if pend is not None:
                assert (pend.frontier is None) == (r_pend.frontier is None)
                if pend.frontier is not None:
                    assert np.array_equal(pend.frontier, r_pend.frontier)
                assert np.array_equal(pend.part_snapshot, r_pend.part_snapshot)
                rep, r_rep = ot.run_invocation(pend), rot.run_invocation(r_pend)
                # an arrival between the run and the commit is grafted on
                b, rb = ms.next_batch(g), rms.next_batch(rg)
                _same_batch(b, rb)
                ot.apply_mutations(b)
                rot.apply_mutations(rb)
                ot.commit_invocation(pend)
                rot.commit_invocation(r_pend)
                assert rep.moves == r_rep.moves
            out = (ot.tick, pend is not None, reason, dirty_before)
            r_out = (rot.tick, r_pend is not None, r_reason, r_dirty_before)
        else:
            st, rst = ot.step(measured_ipt=ipt), rot.step(measured_ipt=ipt)
            out = (st.tick, st.invoked, st.reason, st.dirty_before,
                   st.report.moves if st.report else None)
            r_out = (rst.tick, rst.invoked, rst.reason, rst.dirty_before,
                     rst.report.moves if rst.report else None)
        assert out == r_out
        assert np.array_equal(ot.part, rot.part)
        assert ot.invocations == rot.invocations
        assert np.array_equal(ot._dirty, rot._dirty)
        for q, rq in zip(qs, rqs):
            assert np.array_equal(ex.traversals(q), rex.traversals(rq))
    return ot.invocations


def _online_setup(seed=9, n=1200, k=4):
    g, rg = _pair("musicbrainz_like", n, seed)
    qs = [parse_rpq(t) for t in MQ_TEXT]
    rqs = [r_parse(t) for t in MQ_TEXT]
    ws = WorkloadStream(qs, period=8.0, seed=3)
    rws = RWorkloadStream(rqs, period=8.0, seed=3)
    mkw = dict(mode="mixed", seed=5, vertices_per_tick=2, edges_per_tick=8)
    return g, rg, ws, rws, GraphMutationStream(**mkw), RGraphMutationStream(**mkw), k


@pytest.mark.parametrize("split", [False, True], ids=["step", "begin-run-commit"])
def test_online_trace_equals_reference(split):
    g, rg, ws, rws, ms, rms, k = _online_setup()
    part0 = hash_partition(g.n, k, seed=1)
    pol = dict(cadence=3, dirty_fraction=0.01, drift_l1=0.35)
    cfg = dict(max_iterations=3, seed=0)
    ot = OnlineTaper(g, k, part=part0, config=TaperConfig(**cfg),
                     policy=OnlinePolicy(**pol), device=CPU)
    rot = ROnlineTaper(rg, k, part=part0, config=RTaperConfig(**cfg),
                       policy=ROnlinePolicy(**pol))
    ex, rex = QueryExecutor(g), RQueryExecutor(rg)
    assert _trace(ot, rot, g, rg, 8, ws, rws, ms, rms, ex, rex, split) >= 2


def test_online_from_carried_state_equals_reference():
    """A driver rebuilt from convert's carried graph (version, log) and
    sketch continues exactly as the reference's driver does."""
    g, rg, ws, rws, ms, rms, k = _online_setup(seed=12, n=1000)
    rsk = RFrequencySketch(half_life=4.0)
    rot = ROnlineTaper(rg, k, policy=ROnlinePolicy(cadence=2, dirty_fraction=0.01),
                       sketch=rsk)
    rex = RQueryExecutor(rg)
    for _ in range(3):                 # the reference runs alone for a while
        rws.advance(1.0)
        ws.advance(1.0)
        rot.observe(rws.sample(80))
        ws.sample(80)
        rot.apply_mutations(rms.next_batch(rg))
        rot.step(measured_ipt=rex.workload_ipt(rws.workload(), rot.part))
    state = from_reference_arrays(
        graph=dict(n=rg.n, labels=rg.labels, label_names=rg.label_names,
                   src=rg.src, dst=rg.dst, version=rg.version,
                   mutation_log=r_log_state(rg.mutation_log)),
        part=rot.part, sketch=rsk.state_dict())
    g = state.graph
    assert g.version == rg.version > 0
    ot = OnlineTaper(g, k, part=state.part, sketch=state.sketch,
                     policy=OnlinePolicy(cadence=2, dirty_fraction=0.01), device=CPU)
    # carry the driver's own counters and the stream's generator state
    ot.tick, ot.invocations = rot.tick, rot.invocations
    ot._last_invoke_tick = rot._last_invoke_tick
    ot._freqs_at_invoke = dict(rot._freqs_at_invoke)
    ot._dirty = rot._dirty.copy()
    ms._rng.bit_generator.state = rms._rng.bit_generator.state
    ms.tick = rms.tick
    ex = QueryExecutor(g)
    r_fresh = RQueryExecutor(rg)
    assert _trace(ot, rot, g, rg, 3, ws, rws, ms, rms, ex, r_fresh) >= 1


# ---------------------------------------------------------------------------
# twins of tests/test_online_taper.py
# ---------------------------------------------------------------------------


def test_mutation_stream_grow():
    g = musicbrainz_like(1000, seed=1)
    s = GraphMutationStream(mode="grow", vertices_per_tick=5, seed=0)
    n0, m0 = g.n, g.m
    g.apply_mutations(s.next_batch(g))
    assert g.n == n0 + 5
    assert g.m > m0


def test_mutation_stream_churn_keeps_size():
    g = musicbrainz_like(1000, seed=1)
    s = GraphMutationStream(mode="churn", edges_per_tick=10, seed=0)
    n0 = g.n
    g.apply_mutations(s.next_batch(g))
    assert g.n == n0


def test_mutation_stream_burst_quiet_then_spike():
    g = musicbrainz_like(800, seed=2)
    s = GraphMutationStream(mode="burst", burst_every=3, seed=0)
    assert s.next_batch(g).is_empty
    assert s.next_batch(g).is_empty
    spike = s.next_batch(g)
    assert not spike.is_empty
    assert len(spike.add_vertex_labels) > 0


def test_mutation_stream_deterministic():
    g1 = musicbrainz_like(800, seed=3)
    g2 = musicbrainz_like(800, seed=3)
    b1 = GraphMutationStream(mode="mixed", seed=9).next_batch(g1)
    b2 = GraphMutationStream(mode="mixed", seed=9).next_batch(g2)
    _same_batch(b1, b2)


def test_candidate_mask_restricts_moves():
    g = power_law_labelled(300, n_labels=4, avg_degree=5.0, seed=7)
    k = 3
    part = hash_partition(g.n, k, seed=1)
    trie = TPSTry.from_workload(
        [(parse_rpq("L0.(L1|L2).L3"), 1.0)]).compile(g.label_names)
    fld = extroversion_field(g, trie, part, k, device=CPU)
    allowed = np.zeros(g.n, dtype=bool)
    allowed[: g.n // 10] = True
    new_part, _ = swap_iteration(
        g, part, fld, k, SwapConfig(), np.random.default_rng(0),
        candidate_mask=allowed)
    for v in np.nonzero(new_part != part)[0]:
        assert allowed[v] or allowed[g.neighbors(v)].any()


def test_taper_invoke_frontier_smoke():
    g = musicbrainz_like(1500, seed=4)
    taper = Taper(g, 4, TaperConfig(max_iterations=3), device=CPU)
    rep = taper.invoke(hash_partition(g.n, 4, seed=1), _workload(),
                       frontier=np.arange(50))
    assert rep.final_part.shape == (g.n,)
    assert partition_balance(rep.final_part, 4) <= 1.06


def test_online_taper_places_new_vertices_and_invokes():
    g = musicbrainz_like(1200, seed=5)
    ot = OnlineTaper(g, 4, policy=OnlinePolicy(cadence=2, dirty_fraction=0.01),
                     device=CPU)
    ws = WorkloadStream([MQ1, MQ3], period=6.0, seed=2)
    ms = GraphMutationStream(mode="mixed", seed=3, vertices_per_tick=3,
                             edges_per_tick=8)
    for _ in range(4):
        ws.advance(1.0)
        ot.observe(ws.sample(60))
        ot.apply_mutations(ms.next_batch(g))
        ot.step()
    assert ot.part.shape == (g.n,)
    assert (ot.part >= 0).all() and (ot.part < 4).all()
    assert ot.invocations >= 1
    assert partition_balance(ot.part, 4) <= 1.10


def test_online_ingest_rejects_stale_or_skipped_records():
    g = musicbrainz_like(600, seed=10)
    ot = OnlineTaper(g, 4, device=CPU)
    ms = GraphMutationStream(mode="grow", vertices_per_tick=2, seed=1)
    a1 = g.apply_mutations(ms.next_batch(g))
    a2 = g.apply_mutations(ms.next_batch(g))
    with pytest.raises(ValueError, match="stale"):
        ot.ingest(a1)
    with pytest.raises(ValueError, match="non-contiguous"):
        ot.ingest(a2)


def test_online_taper_no_workload_no_invoke():
    g = musicbrainz_like(800, seed=6)
    ot = OnlineTaper(g, 4, policy=OnlinePolicy(cadence=1, min_interval=0),
                     device=CPU)
    assert not ot.step().invoked


def test_online_policy_workload_drift_trigger():
    g = musicbrainz_like(800, seed=7)
    ot = OnlineTaper(g, 4, policy=OnlinePolicy(
        cadence=100, dirty_fraction=1.0, drift_l1=0.3), device=CPU)
    ot.observe([MQ1] * 50)
    assert not ot.step().invoked      # no baseline yet: drift undefined
    ot.invoke(reason="manual")        # establish the baseline
    ot.observe([MQ1] * 50)
    assert not ot.step().invoked      # same workload: no drift
    for _ in range(6):
        ot.observe([MQ3] * 50)
    rep = ot.step()
    assert rep.invoked and rep.reason == "workload"


def test_online_policy_topology_trigger_is_frontier_local():
    g = musicbrainz_like(1000, seed=8)
    ot = OnlineTaper(g, 4, policy=OnlinePolicy(
        cadence=100, dirty_fraction=0.005, drift_l1=9.9), device=CPU)
    ot.observe([MQ1, MQ3] * 30)
    ot.invoke(reason="manual")
    ms = GraphMutationStream(mode="churn", edges_per_tick=20, seed=4)
    ot.apply_mutations(ms.next_batch(g))
    rep = ot.step()
    assert rep.invoked and rep.reason == "topology"
    assert int(ot._dirty.sum()) == 0


def test_online_ipt_under_drift_beats_hash():
    g = musicbrainz_like(2000, seed=9)
    k = 4
    ws = WorkloadStream([MQ1, MQ3], period=8.0, seed=3)
    ms = GraphMutationStream(mode="mixed", seed=5, vertices_per_tick=2,
                             edges_per_tick=6)
    ex = QueryExecutor(g)
    part0 = Taper(g, k, TaperConfig(max_iterations=4), device=CPU).invoke(
        hash_partition(g.n, k, seed=1), ws.workload()).final_part
    ot = OnlineTaper(g, k, part=part0, policy=OnlinePolicy(
        cadence=3, dirty_fraction=0.01), device=CPU)
    wins = 0
    for _ in range(5):
        ws.advance(1.0)
        ot.observe(ws.sample(80))
        ot.apply_mutations(ms.next_batch(g))
        w = ws.workload()
        ot.step(measured_ipt=ex.workload_ipt(w, ot.part))
        wins += ex.workload_ipt(w, ot.part) < ex.workload_ipt(
            w, hash_partition(g.n, k, seed=1))
    assert wins >= 4


def _regressed_online_taper(**policy_overrides):
    g = musicbrainz_like(800, seed=10)
    pol = OnlinePolicy(cadence=1000, min_interval=0, dirty_fraction=1.0,
                       drift_l1=9e9, ipt_regression=1.2, **policy_overrides)
    ot = OnlineTaper(g, 4, policy=pol, device=CPU)
    ot.observe([MQ1, MQ3] * 30)
    ot.invoke(reason="manual")
    assert not ot.step(measured_ipt=100.0).invoked   # first measurement
    return ot


def test_ipt_regression_trigger_fires_without_gate():
    rep = _regressed_online_taper().step(measured_ipt=200.0)
    assert rep.invoked and rep.reason == "ipt"


def test_ipt_regression_gated_by_migration_cost():
    ot = _regressed_online_taper(min_ipt_gain_per_mb=1e12)
    assert not ot.step(measured_ipt=200.0).invoked
    ot.policy.min_ipt_gain_per_mb = 50.0 / (ot.estimated_migration_bytes() / 2**20)
    rep = ot.step(measured_ipt=200.0)
    assert rep.invoked and rep.reason == "ipt"


def test_estimated_migration_bytes_degree_proportional():
    g = musicbrainz_like(600, seed=11)
    ot = OnlineTaper(g, 4, policy=OnlinePolicy(migration_bytes_per_edge=64.0),
                     device=CPU)
    base = ot.estimated_migration_bytes()
    assert base > 0
    ot.policy.migration_bytes_per_edge = 128.0
    assert ot.estimated_migration_bytes() == pytest.approx(2 * base)
    ot.observe([MQ1, MQ3] * 30)
    ot.invoke(reason="manual")
    assert ot.estimated_migration_bytes() == pytest.approx(
        max(ot._last_total_moves, 0) * g.m / g.n * 128.0)


def test_pressure_defers_and_accelerates():
    g = musicbrainz_like(600, seed=12)
    ot = OnlineTaper(g, 4, policy=OnlinePolicy(
        cadence=1, defer_above_pressure=0.8, accelerate_below_pressure=0.2,
        ipt_regression=2.0), device=CPU)
    ot.observe([MQ1] * 10)
    assert ot.poll(pressure=0.9) is None and ot.pressure_deferrals == 1
    assert ot.poll(pressure=0.5) == "cadence"
    ot.invoke("manual")
    ot.poll(measured_ipt=100.0)
    ot.policy.cadence = 1000
    assert ot.poll(measured_ipt=160.0, pressure=0.1) == "ipt"   # 1.6 >= 1.5
    assert ot.poll(measured_ipt=160.0, pressure=0.5) is None


def test_online_taper_defaults_to_the_card():
    g = musicbrainz_like(300, seed=14)
    if torch.cuda.is_available():
        assert OnlineTaper(g, 4).taper.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            OnlineTaper(g, 4)


def test_placement_prior_follows_field():
    g = musicbrainz_like(600, seed=13)
    ot = OnlineTaper(g, 4, device=CPU)
    assert ot.placement_pr() is None
    ot.restore_placement_prior(np.ones(g.n))
    assert np.array_equal(ot.placement_pr(), np.ones(g.n))
    ot.observe([MQ1, MQ3] * 10)
    ot.invoke("manual")
    assert ot.placement_pr() is ot.taper._field_memo[1].pr


# ---------------------------------------------------------------------------
# twins of tests/test_sketch.py
# ---------------------------------------------------------------------------


Q = [parse_rpq(s) for s in ("a.b", "b.c", "c.(a|b)", "a.(b)*.c")]


def _eager_frequencies(observations, half_life, min_freq=1e-4):
    d = 0.5 ** (1.0 / half_life)
    counts = {}
    for q, w in observations:
        for key in counts:
            counts[key] *= d
        counts[q.qhash] = counts.get(q.qhash, 0.0) + w
    total = sum(counts.values())
    out = {key: v / total for key, v in counts.items()}
    return {key: (v if v >= min_freq else 0.0) for key, v in out.items()}


def test_lazy_observe_matches_eager():
    rng = np.random.default_rng(0)
    obs = [(Q[int(i)], float(w))
           for i, w in zip(rng.integers(0, len(Q), 200), rng.uniform(0.5, 2.0, 200))]
    sk = FrequencySketch(half_life=17.0)
    for q, w in obs:
        sk.observe(q, w)
    expect = _eager_frequencies(obs, 17.0)
    got = sk.frequencies()
    assert set(got) == set(expect)
    for key in expect:
        assert got[key] == pytest.approx(expect[key], rel=1e-9)


def test_observe_is_o1_touches_only_observed_counter():
    sk = FrequencySketch(half_life=10.0)
    sk.observe(Q[0])
    stored_before = sk.counts[Q[0].qhash]
    for _ in range(50):
        sk.observe(Q[1])
    assert sk.counts[Q[0].qhash] == stored_before
    freqs = sk.frequencies(min_freq=0.0)
    expect0 = sk.decay ** 50 / (sk.decay ** 50 + sum(sk.decay ** i for i in range(50)))
    assert freqs[Q[0].qhash] == pytest.approx(expect0, rel=1e-9)


def test_observe_batch_decays_once_per_batch():
    sk = FrequencySketch(half_life=4.0)
    sk.observe_batch([Q[0]] * 10)
    assert sk.frequencies(min_freq=0.0)[Q[0].qhash] == pytest.approx(1.0)
    sk.observe_batch([Q[1]] * 1000)
    vals = sk._decayed()
    assert vals[Q[0].qhash] == pytest.approx(10 * sk.decay, rel=1e-12)
    assert vals[Q[1].qhash] == pytest.approx(1000.0)


def test_preseeded_counts_survive():
    sk = FrequencySketch(half_life=10.0, counts={Q[0].qhash: 2.0},
                         queries={Q[0].qhash: Q[0]})
    assert sk.frequencies(min_freq=0.0)[Q[0].qhash] == pytest.approx(1.0)
    sk.observe(Q[0])
    assert sk._decayed()[Q[0].qhash] == pytest.approx(2.0 * sk.decay + 1.0, rel=1e-12)


def test_empty_batch_is_noop():
    sk = FrequencySketch()
    sk.observe(Q[0])
    t = sk._ticks
    sk.observe_batch([])
    assert sk._ticks == t


def test_workload_snapshot_roundtrip():
    sk = FrequencySketch(half_life=100.0)
    sk.observe_batch([Q[0]] * 3 + [Q[1]])
    wl = dict((q.qhash, f) for q, f in sk.workload())
    assert wl[Q[0].qhash] == pytest.approx(0.75)
    assert wl[Q[1].qhash] == pytest.approx(0.25)
    back = FrequencySketch.from_state(sk.state_dict())
    assert back.frequencies() == sk.frequencies()


# ---------------------------------------------------------------------------
# twin of tests/test_property_dynamic.py
# ---------------------------------------------------------------------------


@st.composite
def mutation_scenario(draw):
    n = draw(st.integers(40, 250))
    seed = draw(st.integers(0, 2**16))
    specs = draw(st.lists(
        st.tuples(st.integers(0, 4), st.integers(0, 12), st.integers(0, 12),
                  st.booleans(), st.integers(0, 3)),
        min_size=1, max_size=3))
    return n, seed, specs


@given(mutation_scenario())
@settings(max_examples=15, deadline=None,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])
def test_random_mutation_batches_bitwise_parity(scenario):
    n, seed, specs = scenario
    g = power_law_labelled(n, n_labels=4, avg_degree=5.0, seed=seed)
    rng = np.random.default_rng(seed + 1)
    q = parse_rpq("L0.(L1|L2).L3")
    _seed_caches(g)
    ex = QueryExecutor(g)
    ex.traversals(q)
    for nv, na, nr, drop_vertex, nrl in specs:
        rem_v = [int(rng.integers(0, g.n))] if drop_vertex else []
        g.apply_mutations(MutationBatch(**_random_spec(g, rng, nv, na, nr, rem_v, nrl)))
        g.validate()
        _assert_full_parity(g, queries=[(ex, q)])
