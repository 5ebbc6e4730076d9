"""Twins of ``tests/test_tpstry.py``, ``test_rpq.py`` and
``test_property_core.py`` on the port.

The paper's §4.1 worked example (Fig. 3 / Fig. 4) is pinned on the port's
``TPSTry`` (Pr(E→a) = 0.75, Pr(E→a→b) = 0.25, …); the RPQ language's
expansions and the trie's path queries equal the reference's; the
Hypothesis properties hold on the port's ``torch`` field, swap and executor,
with the swap's partition and the executor's ipt bitwise the reference's on
each drawn case; and ``synthetic_trie`` is bitwise the reference's.  Trie
numbering follows the string-hash seed, so both packages run in one
process."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import HealthCheck, given, settings, strategies as st

from repro.core import rpq as r_rpq
from repro.core.swap import SwapConfig as RSwapConfig
from repro.core.swap import swap_iteration as r_swap_iteration
from repro.core.tpstry import TPSTry as RTPSTry
from repro.core.tpstry import synthetic_trie as r_synthetic_trie
from repro.core.visitor import ExtroversionResult as RField
from repro.graphs.generators import power_law_labelled as r_power_law
from repro.workload.executor import QueryExecutor as RQueryExecutor

from repro_torch.core.rpq import concat, label, parse_rpq, star, union
from repro_torch.core.swap import SwapConfig, swap_iteration
from repro_torch.core.tpstry import TPSTry, synthetic_trie
from repro_torch.core.visitor import extroversion_field
from repro_torch.graphs.generators import paper_example_graph, power_law_labelled
from repro_torch.graphs.partition import hash_partition
from repro_torch.workload.executor import QueryExecutor

Q1, Q2 = "a.(b|c).(c|d)", "(c|a).c.a"
TRIE_FIELDS = ("parent", "label", "depth", "p", "cond_p", "child_index",
               "is_leaf")


def _paper_workload(parse=parse_rpq):
    return [(parse(Q1), 0.5), (parse(Q2), 0.5)]


@pytest.fixture
def paper_trie():
    return TPSTry.from_workload(_paper_workload())


# ---------------------------------------------------------------------------
# tests/test_tpstry.py: the paper's worked example
# ---------------------------------------------------------------------------

PAPER_PATHS = [
    (["a"], 0.75),            # Pr(E->a), the §4.1 worked example
    (["c"], 0.25),
    (["a", "b"], 0.25),       # Pr(E->a->b)
    (["a", "c"], 0.5),
    (["c", "c"], 0.25),
    (["a", "b", "c"], 0.125),
    (["a", "b", "d"], 0.125),
    (["a", "c", "c"], 0.125),
    (["a", "c", "d"], 0.125),
    (["a", "c", "a"], 0.25),
    (["c", "c", "a"], 0.25),
    (["b"], 0.0),             # no such path
]


@pytest.mark.parametrize("path,p", PAPER_PATHS,
                         ids=["".join(p) for p, _ in PAPER_PATHS])
def test_paper_trie_probabilities(paper_trie, path, p):
    """Exact numbers from §4.1 and Fig. 4(right), and the reference's."""
    assert paper_trie.prob_of_path(path) == pytest.approx(p)
    ref = RTPSTry.from_workload(_paper_workload(r_rpq.parse_rpq))
    assert paper_trie.prob_of_path(path) == ref.prob_of_path(path)


def test_trie_structure(paper_trie):
    # Fig 3(b): merged trie with nodes for both queries
    t = paper_trie
    assert t.node_by_path(["a"]) is not None
    assert t.node_by_path(["c", "c", "a"]) is not None
    assert t.node_by_path(["b"]) is None
    assert t.max_depth == 3
    # node 'a' and 'ac' are labelled with both queries (paper fn. 4)
    q1, q2 = parse_rpq(Q1), parse_rpq(Q2)
    assert t.node_by_path(["a"]).queries == {q1.qhash, q2.qhash}
    assert t.node_by_path(["a", "c"]).queries == {q1.qhash, q2.qhash}
    assert t.node_by_path(["a", "b"]).queries == {q1.qhash}
    ref = RTPSTry.from_workload(_paper_workload(r_rpq.parse_rpq))
    for path in (["a"], ["a", "c"], ["c", "c", "a"]):
        a, b = t.node_by_path(path), ref.node_by_path(path)
        assert (a.node_id, a.depth, a.p, a.queries) == (
            b.node_id, b.depth, b.p, b.queries)


def test_frequencies_are_the_references(paper_trie):
    ref = RTPSTry.from_workload(_paper_workload(r_rpq.parse_rpq))
    assert paper_trie.frequencies() == ref.frequencies()
    assert sorted(paper_trie.frequencies().values()) == [0.5, 0.5]
    # a copy: writing to it leaves the trie alone
    paper_trie.frequencies().clear()
    assert len(paper_trie.frequencies()) == 2


def test_frequency_zero_removes_query():
    """§4: an expression with frequency 0 has its labels (and orphaned
    nodes) removed and is treated as new in future."""
    trie = TPSTry.from_workload(_paper_workload())
    n_before = trie.n_nodes
    (q1, _), (q2, _) = _paper_workload()
    trie.set_frequencies({q1.qhash: 1.0, q2.qhash: 0.0})
    assert trie.node_by_path(["c", "c"]) is None        # only Q2 used cc
    assert trie.node_by_path(["a", "c", "a"]) is None   # only Q2 used aca
    assert trie.node_by_path(["a", "b"]) is not None
    assert trie.n_nodes < n_before
    # with Q1 alone its conditionals renormalise
    assert trie.prob_of_path(["a"]) == pytest.approx(1.0)
    assert trie.prob_of_path(["a", "b"]) == pytest.approx(0.5)
    assert trie.frequencies() == {q1.qhash: 1.0}


def test_right_stochastic_children(paper_trie):
    """Children of any node sum to at most the node's probability (the
    shortfall is termination mass)."""
    for node in paper_trie.nodes:
        p_children = sum(paper_trie.nodes[c].p for c in node.children.values())
        p_self = node.p if node.node_id != 0 else 1.0
        assert p_children <= p_self + 1e-9


def test_compile_arrays(paper_trie):
    arrays = paper_trie.compile(paper_example_graph().label_names)
    assert arrays.n_nodes == paper_trie.n_nodes
    assert arrays.max_depth == 3
    # depth ordering: parents precede children
    assert all(arrays.parent[i] < i for i in range(1, arrays.n_nodes))
    d1 = [i for i in range(arrays.n_nodes) if arrays.depth[i] == 1]
    np.testing.assert_allclose(arrays.cond_p[d1], arrays.p[d1], rtol=1e-6)


def test_compile_drops_unknown_symbols(paper_trie):
    arrays = paper_trie.compile(["a", "b", "c"])  # no 'd' in this graph
    assert arrays.n_nodes == paper_trie.n_nodes - 2  # abd / acd dropped


def test_snapshot_change_detection():
    trie = TPSTry.from_workload(_paper_workload())
    trie.snapshot()
    assert not trie.changed_since_snapshot().any()
    (q1, _), (q2, _) = _paper_workload()
    trie.set_frequencies({q1.qhash: 0.9, q2.qhash: 0.1})
    assert trie.changed_since_snapshot().any()


SYNTH = [dict(), dict(n_labels=12, depth=6, branching=3, n_first=4),
         dict(n_labels=5, depth=5, branching=1, n_first=7, seed=3),
         dict(n_labels=64, depth=8, branching=4, n_first=16)]


@pytest.mark.parametrize("kw", SYNTH, ids=[str(i) for i in range(len(SYNTH))])
def test_synthetic_trie_bitwise(kw):
    a, b = synthetic_trie(**kw), r_synthetic_trie(**kw)
    for f in TRIE_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.n_labels == b.n_labels
    assert a.topology_signature() == b.topology_signature()


# ---------------------------------------------------------------------------
# tests/test_rpq.py: the expression language
# ---------------------------------------------------------------------------

EXPANSIONS = [
    ("a.(b|c).(c|d)", 5, 3, {"abc", "abd", "acc", "acd"}),  # paper §4, Q1
    ("(c|a).c.a", 5, 3, {"cca", "aca"}),                    # Q2
    ("a.(b)*", 3, 3, {"a", "ab", "abb"}),
    ("Entity.(Entity)*.Activity", 4, 3, None),
]


@pytest.mark.parametrize("text,max_len,star_max,want", EXPANSIONS,
                         ids=[e[0] for e in EXPANSIONS])
def test_strings_expansion(text, max_len, star_max, want):
    got = parse_rpq(text).strings(max_len=max_len, star_max=star_max)
    ref = r_rpq.parse_rpq(text).strings(max_len=max_len, star_max=star_max)
    assert got == ref
    if want is not None:
        assert {"".join(s) for s in got} == want


def test_star_bounded_expansion():
    # str(e*) bounded by star_max and max_len (paper §4: e^N expansion)
    q = parse_rpq("Entity.(Entity)*.Activity")
    got = {"".join(sym[0] for sym in s)
           for s in q.strings(max_len=4, star_max=3)}
    assert got == {"EA", "EEA", "EEEA"}


def test_parse_roundtrip_and_sugar():
    q = parse_rpq("a.(b|c).(c|d)")
    assert q.op == "concat" and q.to_text() == "a.(b|c).(c|d)"
    assert parse_rpq("a+b").strings(3) == parse_rpq("a|b").strings(3)
    assert parse_rpq("a·b").to_text() == "a.b"
    q = label("a") * (label("b") | label("c"))
    assert {"".join(s) for s in q.strings(3)} == {"ab", "ac"}
    assert concat(label("a"), star(union(label("b"), label("c")))).to_text() \
        == r_rpq.concat(r_rpq.label("a"), r_rpq.star(
            r_rpq.union(r_rpq.label("b"), r_rpq.label("c")))).to_text()


def test_qhash_unique_stable_and_the_references():
    q1, q2 = parse_rpq("a.b"), parse_rpq("a.c")
    assert q1.qhash != q2.qhash
    assert q1.qhash == parse_rpq("a.b").qhash
    for text in ("a.b", Q1, Q2, "Entity.(Entity)*.Entity"):
        assert parse_rpq(text).qhash == r_rpq.parse_rpq(text).qhash


@pytest.mark.parametrize("bad", ["a..b", "(a.b", "a.b)"])
def test_parse_errors(bad):
    with pytest.raises(ValueError):
        parse_rpq(bad)


# ---------------------------------------------------------------------------
# tests/test_property_core.py: invariants on drawn graphs and workloads
# ---------------------------------------------------------------------------

SET = settings(max_examples=20, deadline=None,
               suppress_health_check=[HealthCheck.too_slow,
                                      HealthCheck.data_too_large])
LABELS = ["L0", "L1", "L2", "L3"]


@st.composite
def rpq_text(draw, depth=0):
    """An expression's text (parsed by each package)."""
    if depth >= 2:
        return draw(st.sampled_from(LABELS))
    kind = draw(st.sampled_from(["label", "concat", "union", "star"]))
    if kind == "label":
        return draw(st.sampled_from(LABELS))
    if kind == "star":
        return f"({draw(rpq_text(depth + 1))})*"
    a, b = draw(rpq_text(depth + 1)), draw(rpq_text(depth + 1))
    return f"({a}).({b})" if kind == "concat" else f"({a})|({b})"


@st.composite
def graph_workload(draw):
    n = draw(st.integers(30, 300))
    seed = draw(st.integers(0, 2**16))
    n_q = draw(st.integers(1, 3))
    texts = [draw(rpq_text()) for _ in range(n_q)]
    freqs = [draw(st.floats(0.1, 1.0)) for _ in range(n_q)]
    k = draw(st.integers(2, 5))
    return n, seed, list(zip(texts, freqs)), k


def _build(case):
    n, seed, workload, k = case
    g = power_law_labelled(n, n_labels=4, avg_degree=5.0, seed=seed)
    w = [(parse_rpq(t), f) for t, f in workload]
    try:
        trie = TPSTry.from_workload(w, max_len=4)
    except ValueError:
        trie = None  # all queries expanded empty — fine
    return g, w, trie


def _field(g, trie, part, k):
    return extroversion_field(g, trie.compile(g.label_names), part, k,
                              backend="torch", device="cpu")


@given(graph_workload())
@SET
def test_extroversion_bounds_and_decomposition(case):
    g, _, trie = _build(case)
    if trie is None:
        return
    k, seed = case[3], case[1]
    fld = _field(g, trie, hash_partition(g.n, k, seed), k)
    assert np.isfinite(fld.extroversion).all()
    assert (fld.extroversion >= -1e-6).all()
    assert (fld.extroversion <= 1.0 + 1e-5).all()
    assert (fld.pr >= -1e-7).all()
    assert (fld.edge_mass >= -1e-7).all()
    # per-destination decomposition sums to total external mass
    np.testing.assert_allclose(fld.ext_to.sum(axis=1), fld.extro_mass,
                               rtol=1e-4, atol=1e-6)
    # out-flowing mass never exceeds the probability of being at the vertex
    out_mass = np.zeros(g.n)
    np.add.at(out_mass, g.src, fld.edge_mass)
    assert (out_mass <= fld.pr * (1 + 1e-4) + 1e-6).all()


@given(graph_workload())
@SET
def test_single_partition_has_no_extroversion(case):
    g, _, trie = _build(case)
    if trie is None:
        return
    fld = _field(g, trie, np.zeros(g.n, dtype=np.int32), 1)
    np.testing.assert_allclose(fld.extro_mass, 0.0, atol=1e-7)


@given(graph_workload())
@SET
def test_swap_iteration_invariants_and_the_references(case):
    """Valid partition, moves counted; the reference's swap on the same
    field gives the same partition and stats."""
    import dataclasses

    g, _, trie = _build(case)
    if trie is None:
        return
    n, seed, _, k = case
    part = hash_partition(g.n, k, seed)
    fld = _field(g, trie, part, k)
    new_part, stats = swap_iteration(g, part, fld, k,
                                     SwapConfig(balance_eps=0.2),
                                     np.random.default_rng(0))
    assert new_part.shape == part.shape
    assert new_part.min() >= 0 and new_part.max() < k
    assert stats.moves == int((new_part != part).sum())
    rfld = RField(**{f.name: getattr(fld, f.name)
                     for f in dataclasses.fields(RField)})
    rg = r_power_law(n, n_labels=4, avg_degree=5.0, seed=seed)
    r_part, r_stats = r_swap_iteration(rg, part, rfld, k,
                                       RSwapConfig(balance_eps=0.2),
                                       np.random.default_rng(0))
    assert np.array_equal(new_part, r_part)
    assert dataclasses.asdict(stats) == dataclasses.asdict(r_stats)


@given(graph_workload())
@SET
def test_ipt_bounded_by_total_traversals(case):
    n, seed, workload, k = case
    g = power_law_labelled(n, n_labels=4, avg_degree=5.0, seed=seed)
    ex = QueryExecutor(g, max_len=4)
    rex = RQueryExecutor(r_power_law(n, n_labels=4, avg_degree=5.0,
                                     seed=seed), max_len=4)
    part = hash_partition(g.n, k, seed)
    for text, _ in workload:
        q = parse_rpq(text)
        try:
            total = ex.total_traversals(q)
        except ValueError:
            continue
        ipt = ex.ipt(q, part)
        assert 0.0 <= ipt <= total + 1e-6
        assert ex.ipt(q, np.zeros(g.n, dtype=np.int32)) == 0.0
        assert ipt == rex.ipt(r_rpq.parse_rpq(text), part)


@given(rpq_text())
@SET
def test_trie_probability_monotone(text):
    try:
        trie = TPSTry.from_workload([(parse_rpq(text), 1.0)], max_len=4)
    except ValueError:
        return
    for node in trie.nodes:
        p_self = node.p if node.node_id != 0 else 1.0
        kids = sum(trie.nodes[c].p for c in node.children.values())
        assert kids <= p_self + 1e-9
        for c in node.children.values():
            assert trie.nodes[c].p <= p_self + 1e-9
