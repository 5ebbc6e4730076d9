"""The port's batched frontier path enumeration against the JAX package's.

Twins of ``tests/test_enum_vectorised.py`` and of
``tests/test_serve_loop.py``'s enumeration tests: on the same graph
(generated from the same seed by either package), query, partition and
truncation, ``repro_torch``'s ``enumerate_paths`` / ``enumerate_paths_many``
equal its own DFS oracle ``enumerate_paths_ref`` and the reference
executor's results bit for bit (paths, emission order, ipt), before and
after mutations and from several threads at once."""
import threading

import numpy as np
import pytest

from repro.core.rpq import parse_rpq as r_parse
from repro.graphs import generators as RG
from repro.graphs.graph import MutationBatch as RMutationBatch
from repro.workload.executor import QueryExecutor as RQueryExecutor
from repro_torch.core.online import OnlinePolicy
from repro_torch.core.rpq import parse_rpq
from repro_torch.graphs import generators as PG
from repro_torch.graphs.graph import MutationBatch
from repro_torch.graphs.partition import hash_partition
from repro_torch.serve.loop import ServeLoopConfig, ServingLoop
from repro_torch.workload.executor import QueryExecutor

MB_QUERIES = ["Area.Artist.(Artist|Label).Area",
              "Artist.Credit.(Track|Recording).Credit.Artist",
              "Artist.Credit.Track.Medium"]
PG_QUERIES = ["Entity.(Entity)*.Entity", "Agent.Activity.Entity.Entity.Activity.Agent",
              "(Entity)*.Activity.Entity", "Entity.Activity.(Agent)*"]
PL_QUERIES = ["L0.L1", "L1.(L0|L2).L1", "(L0)*.L1", "L2.(L1)*",
              "L0.(L1|L2|L3).(L0|L1).L2", "(L3)*"]


def _pair(gen, *args, **kw):
    """The same generated graph from both packages, and both executors."""
    g, rg = getattr(PG, gen)(*args, **kw), getattr(RG, gen)(*args, **kw)
    assert np.array_equal(g.src, rg.src) and np.array_equal(g.labels, rg.labels)
    return g, rg


def _assert_parity(ex, rex, text, max_results, part):
    """Batched == the port's DFS == the reference's batched enumeration."""
    q, rq = parse_rpq(text), r_parse(text)
    got = ex.enumerate_paths(q, max_results, part)
    assert got == ex.enumerate_paths_ref(q, max_results, part), (text, max_results)
    assert got == rex.enumerate_paths(rq, max_results, part), (text, max_results)
    return got


@pytest.mark.parametrize("gname", ["mb", "pg", "pl"])
def test_parity_random_graphs(gname):
    rng = np.random.default_rng(0)
    if gname == "mb":
        (g, rg), texts = _pair("musicbrainz_like", 1500, seed=5), MB_QUERIES
    elif gname == "pg":
        (g, rg), texts = _pair("provgen_like", 1500, seed=5), PG_QUERIES
    else:
        (g, rg), texts = _pair("power_law_labelled", 800, n_labels=4, seed=5), PL_QUERIES
    ex, rex = QueryExecutor(g), RQueryExecutor(rg)
    part = rng.integers(0, 8, g.n)
    for text in texts:
        for mr in (1, 7, 32, 10 ** 9):
            _assert_parity(ex, rex, text, mr, part)


def test_parity_paper_graph():
    g, rg = PG.paper_example_graph(), RG.paper_example_graph()
    ex, rex = QueryExecutor(g), RQueryExecutor(rg)
    part = np.zeros(g.n, dtype=np.int64)
    part[g.n // 2:] = 1
    for text in ("a.(b|c).(c|d)", "(c|a).c.a"):
        _assert_parity(ex, rex, text, 100, part)


def test_truncation_boundaries():
    g, rg = _pair("power_law_labelled", 600, n_labels=3, seed=1)
    ex, rex = QueryExecutor(g), RQueryExecutor(rg)
    part = np.random.default_rng(1).integers(0, 4, g.n)
    text = "L0.(L1|L2).L0"
    full, _ = ex.enumerate_paths_ref(parse_rpq(text), 10 ** 9, part)
    total = len(full)
    assert total > 2
    assert QueryExecutor.ENUM_CHUNK0 == RQueryExecutor.ENUM_CHUNK0
    for mr in (0, 1, 2, total - 1, total, total + 1, QueryExecutor.ENUM_CHUNK0 - 1,
               QueryExecutor.ENUM_CHUNK0, QueryExecutor.ENUM_CHUNK0 + 1):
        _assert_parity(ex, rex, text, mr, part)
    got, _ = ex.enumerate_paths(parse_rpq(text), min(5, total), part)
    assert got == full[:min(5, total)]


def test_kleene_star_at_star_max():
    g, rg = _pair("power_law_labelled", 400, n_labels=3, seed=2)
    for star_max in (1, 2, 3, 4):
        ex, rex = QueryExecutor(g, star_max=star_max), RQueryExecutor(rg, star_max=star_max)
        part = np.random.default_rng(2).integers(0, 4, g.n)
        for text in ("(L0)*.L1", "L1.(L2)*", "(L0)*"):
            paths, _ = _assert_parity(ex, rex, text, 10 ** 9, part)
            plan = ex._enum_plan(parse_rpq(text))
            assert plan.targets == rex._enum_plan(r_parse(text)).targets
            max_len = max((len(t) for t in plan.targets), default=0)
            assert all(len(p) <= max_len for p in paths)


def test_many_matches_per_query_and_order():
    g, rg = _pair("musicbrainz_like", 1200, seed=7)
    ex, rex = QueryExecutor(g), RQueryExecutor(rg)
    part = np.random.default_rng(7).integers(0, 8, g.n)
    outs = ex.enumerate_paths_many([parse_rpq(t) for t in MB_QUERIES], 32, part)
    assert outs == rex.enumerate_paths_many([r_parse(t) for t in MB_QUERIES], 32, part)
    for text, out in zip(MB_QUERIES, outs):
        assert out == ex.enumerate_paths_ref(parse_rpq(text), 32, part)


def test_duplicate_query_fanout_does_not_alias():
    g, _ = _pair("musicbrainz_like", 800, seed=3)
    ex = QueryExecutor(g)
    part = np.random.default_rng(3).integers(0, 4, g.n)
    q = parse_rpq(MB_QUERIES[0])
    outs = ex.enumerate_paths_many([q, parse_rpq(MB_QUERIES[1]), q, q], 16, part)
    assert outs[0] == outs[2] == outs[3]
    ref = list(outs[2][0])
    outs[0][0].append(("sentinel",))
    assert outs[2][0] == ref and outs[3][0] == ref


def test_enum_counters_surface():
    g, rg = _pair("musicbrainz_like", 800, seed=4)
    got = []
    for ex, parse in ((QueryExecutor(g), parse_rpq), (RQueryExecutor(rg), r_parse)):
        stats = {}
        ex.enumerate_paths_many([parse(t) for t in MB_QUERIES], 32,
                                np.zeros(g.n, np.int64), stats=stats)
        assert stats["enum_sweeps"] > 0 and stats["frontier_rows"] > 0
        assert ex.last_enum_stats == stats
        ex.enumerate_paths(parse(MB_QUERIES[0]), 8)
        got.append((stats, ex.collect()))
    # the executor's collect() counters, the reference's key for key
    assert got[0] == got[1]
    assert set(got[0][1]) == {"enum_calls", "enum_sweeps", "frontier_rows",
                              "plans_compiled", "plan_cache_hits", "plan_cache_size",
                              "count_cache_size"}


def test_parity_survives_mutations():
    g, rg = _pair("power_law_labelled", 500, n_labels=3, seed=6)
    ex, rex = QueryExecutor(g), RQueryExecutor(rg)
    part = np.random.default_rng(6).integers(0, 4, g.n)
    text = "L0.(L1|L2).L0"
    _assert_parity(ex, rex, text, 10 ** 9, part)
    rng = np.random.default_rng(8)
    edges = np.stack([rng.integers(0, g.n, 12), rng.integers(0, g.n, 12)], axis=1)
    relabel = [(int(rng.integers(0, g.n)), 0)]
    g.apply_mutations(MutationBatch(add_edges=edges, relabel=relabel))
    rg.apply_mutations(RMutationBatch(add_edges=edges, relabel=relabel))
    _assert_parity(ex, rex, text, 10 ** 9, part)
    _assert_parity(ex, rex, text, 5, part)


def test_plan_cache_is_lru():
    g, _ = _pair("power_law_labelled", 200, n_labels=4, seed=9)
    ex = QueryExecutor(g)
    assert ex.PLAN_CACHE_LIMIT == RQueryExecutor.PLAN_CACHE_LIMIT
    hot = parse_rpq("L0.L1")
    hot_plan = ex._enum_plan(hot)
    for i in range(ex.PLAN_CACHE_LIMIT + 16):
        ex._enum_plan(parse_rpq("L0." * (i // 4 + 1) + f"L{i % 4}"))
        assert ex._enum_plan(hot) is hot_plan
    assert len(ex._plan_cache) <= ex.PLAN_CACHE_LIMIT


def test_plan_cache_evicts_cold():
    g, _ = _pair("power_law_labelled", 200, n_labels=4, seed=9)
    ex = QueryExecutor(g)
    cold = parse_rpq("L3.L3")
    cold_plan = ex._enum_plan(cold)
    for i in range(ex.PLAN_CACHE_LIMIT + 1):
        ex._enum_plan(parse_rpq("L0." * (i // 4 + 1) + f"L{i % 4}"))
    assert ex._enum_plan(cold) is not cold_plan


def test_executor_thread_safety_smoke():
    g, rg = _pair("musicbrainz_like", 800, seed=11)
    ex, rex = QueryExecutor(g), RQueryExecutor(rg)
    part = np.random.default_rng(11).integers(0, 4, g.n)
    queries = [parse_rpq(t) for t in MB_QUERIES]
    expected = rex.enumerate_paths_many([r_parse(t) for t in MB_QUERIES], 16, part)
    errors = []

    def worker():
        try:
            for _ in range(20):
                assert ex.enumerate_paths_many(queries, 16, part) == expected
        except BaseException as exc:  # surfaced by the assert below
            errors.append(exc)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    assert not errors


def test_multi_worker_determinism():
    """Same request stream, no invocations or mutations: per-ticket results
    are identical whatever the worker count, and the reference executor's."""
    queries = [parse_rpq(MB_QUERIES[i % 3]) for i in range(120)]
    rg = RG.musicbrainz_like(1000, seed=13)
    rex = RQueryExecutor(rg)
    ref_part = hash_partition(rg.n, 4, seed=0)
    expected = [rex.enumerate_paths(r_parse(MB_QUERIES[i % 3]), 32, ref_part)
                for i in range(120)]
    for n_workers in (1, 4):
        loop = ServingLoop(
            PG.musicbrainz_like(1000, seed=13), k=4,
            policy=OnlinePolicy(cadence=10 ** 9, bootstrap_after_ticks=10 ** 9),
            config=ServeLoopConfig(n_workers=n_workers, micro_batch=8),
            device="cpu").start()
        assert np.array_equal(loop.part, ref_part)
        tickets = [loop.submit(q) for q in queries]
        assert all(t.accepted for t in tickets)
        for t in tickets:
            assert t.wait(30)
        stats = loop.stop()
        assert [(t.paths, t.ipt) for t in tickets] == expected
        assert stats["completed"] == len(queries) and stats["enum_sweeps"] > 0
        if n_workers > 1:
            assert stats["workers_reporting"] >= 1


def test_multi_worker_with_mutations_and_commit():
    g = PG.musicbrainz_like(800, seed=17)
    loop = ServingLoop(
        g, k=4, policy=OnlinePolicy(cadence=5, min_interval=0, bootstrap_after_ticks=0),
        config=ServeLoopConfig(n_workers=3, micro_batch=8), device="cpu").start()
    rng = np.random.default_rng(17)
    tickets = []
    for i in range(300):
        t = loop.submit(parse_rpq(MB_QUERIES[int(rng.integers(0, 3))]))
        if t.accepted:
            tickets.append(t)
        if i % 40 == 0:
            u, v = int(rng.integers(0, g.n)), int(rng.integers(0, g.n))
            loop.submit_mutations(MutationBatch(add_edges=[(u, v)]))
    for t in tickets:
        assert t.wait(60)
    stats = loop.stop()
    assert stats["invocations"] >= 1 and stats["healthy"] == 1
    assert stats["completed"] == len(tickets)
    assert stats["field_backend"] == "torch"


def test_enumerate_paths_many_matches_per_query():
    g, rg = _pair("musicbrainz_like", 800, seed=7)
    part = hash_partition(g.n, 4, seed=1)
    ex, rex = QueryExecutor(g), RQueryExecutor(rg)
    texts = [MB_QUERIES[0], MB_QUERIES[2], MB_QUERIES[0], MB_QUERIES[0], MB_QUERIES[2]]
    many = ex.enumerate_paths_many([parse_rpq(t) for t in texts], max_results=16, part=part)
    assert many == rex.enumerate_paths_many([r_parse(t) for t in texts],
                                            max_results=16, part=part)
    for text, (paths, ipt) in zip(texts, many):
        assert (paths, ipt) == ex.enumerate_paths(parse_rpq(text), max_results=16, part=part)


def test_enumeration_plan_survives_mutations():
    g, rg = _pair("musicbrainz_like", 500, seed=8)
    ex, rex = QueryExecutor(g), RQueryExecutor(rg)
    for text in (MB_QUERIES[0], MB_QUERIES[2]):   # warm the plan caches
        ex.enumerate_paths(parse_rpq(text), max_results=8)
        rex.enumerate_paths(r_parse(text), max_results=8)
    new_lab = (int(g.labels[0]) + 1) % g.n_labels
    g.apply_mutations(MutationBatch(relabel=[(0, new_lab)], add_edges=[(0, 7)]))
    rg.apply_mutations(RMutationBatch(relabel=[(0, new_lab)], add_edges=[(0, 7)]))
    fresh = QueryExecutor(g)
    for text in (MB_QUERIES[0], MB_QUERIES[2]):
        got = ex.enumerate_paths(parse_rpq(text), max_results=8)
        assert got == fresh.enumerate_paths(parse_rpq(text), max_results=8)
        assert got == rex.enumerate_paths(r_parse(text), max_results=8)


try:
    from hypothesis import HealthCheck, given, settings, strategies as st
    _HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover
    _HAVE_HYPOTHESIS = False

if _HAVE_HYPOTHESIS:
    @st.composite
    def _graph_and_query(draw):
        n_labels = draw(st.integers(min_value=1, max_value=5))
        n = draw(st.integers(min_value=2, max_value=60))
        seed = draw(st.integers(min_value=0, max_value=2 ** 16))
        parts = []
        for _ in range(draw(st.integers(min_value=1, max_value=4))):
            kind = draw(st.sampled_from(["label", "union", "star"]))
            a = draw(st.integers(min_value=0, max_value=n_labels - 1))
            b = draw(st.integers(min_value=0, max_value=n_labels - 1))
            parts.append({"label": f"L{a}", "union": f"(L{a}|L{b})",
                          "star": f"(L{a})*"}[kind])
        return n, n_labels, seed, ".".join(parts)

    @settings(max_examples=40, deadline=None,
              suppress_health_check=[HealthCheck.too_slow])
    @given(_graph_and_query(), st.integers(min_value=0, max_value=64))
    def test_hypothesis_parity_random_alphabets(gq, max_results):
        n, n_labels, seed, text = gq
        g, rg = _pair("power_law_labelled", n, n_labels=n_labels, avg_degree=4.0, seed=seed)
        part = np.random.default_rng(seed).integers(0, 3, g.n)
        _assert_parity(QueryExecutor(g), RQueryExecutor(rg), text, max_results, part)
