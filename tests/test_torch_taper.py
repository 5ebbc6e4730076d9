"""The port's swap, invocation and ipt against the JAX reference.

* ``swap_iteration`` given the *same* field (the reference's, carried over
  by ``repro_torch.convert``) returns the bitwise same partition and stats;
* a lock-step invocation feeds the same partition into both fields every
  iteration and holds them together at rtol 1e-5;
* a full port invocation on the CPU reproduces the fig7 series at N=2000
  exactly (the reference's ``BENCH_PR5..PR10.json`` values);
* ``workload_ipt`` equals the reference's on the same partitions."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core.rpq import parse_rpq as r_parse
from repro.core.swap import SwapConfig as RSwapConfig
from repro.core.swap import swap_iteration as r_swap_iteration
from repro.core.tpstry import TPSTry as RTPSTry
from repro.core.visitor import extroversion_field as r_field
from repro.graphs import generators as rgen
from repro.graphs.partition import hash_partition
from repro.workload.executor import QueryExecutor as RQueryExecutor

from repro_torch.convert import RESULT_FIELDS, from_reference_arrays
from repro_torch.core.rpq import parse_rpq
from repro_torch.core.swap import SwapConfig, swap_iteration
from repro_torch.core.taper import Taper, TaperConfig
from repro_torch.core.tpstry import TPSTry
from repro_torch.core.visitor import extroversion_field
from repro_torch.graphs import generators as pgen
from repro_torch.workload.executor import QueryExecutor

MQ = ["Area.Artist.(Artist|Label).Area",
      "Artist.Credit.(Track|Recording).Credit.Artist",
      "Artist.Credit.Track.Medium"]
PQ = ["Entity.(Entity)*.Entity", "Agent.Activity.Entity.Entity.Activity.Agent",
      "(Entity)*.Activity.Entity", "Entity.Activity.(Agent)*"]
#: fig7 at N=2000, k=8, hash start (seed 1): the reference's ipt series
#: (benchmarks/fig7_convergence.py; identical in BENCH_PR5..PR10.json)
FIG7 = {
    "provgen": ("provgen_like", 11, PQ, (0.4, 0.2, 0.2, 0.2),
                [1634056, 1354268, 1202249, 1031948, 970273, 933984, 913087,
                 911654, 908300]),
    "musicbrainz": ("musicbrainz_like", 13, MQ, (0.2, 0.3, 0.5),
                    [180425, 156093, 128261, 111282, 99870, 96681, 96536]),
}
CASES = [
    (7, "provgen_like", ["Entity.Entity.Entity", "Agent.Activity.Entity"], 4),
    (3, "musicbrainz_like", ["Area.Artist.(Artist|Label).Area"], 8),
    (11, "provgen_like", ["Entity.Activity.Agent", "Entity.(Entity)*.Entity"], 3),
]


def _graphs(gen, n, seed):
    rg = getattr(rgen, gen)(n, seed=seed)
    state = from_reference_arrays(graph=dict(
        n=rg.n, labels=rg.labels, label_names=rg.label_names, src=rg.src,
        dst=rg.dst))
    return state.graph, rg


def _workloads(queries, freqs=None):
    freqs = freqs or [1.0 / len(queries)] * len(queries)
    return ([(parse_rpq(q), f) for q, f in zip(queries, freqs)],
            [(r_parse(q), f) for q, f in zip(queries, freqs)])


@pytest.mark.parametrize("case", CASES, ids=[f"seed{c[0]}" for c in CASES])
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "two-phase"])
def test_swap_on_reference_field_bitwise(case, dense):
    seed, gen, queries, k = case
    g, rg = _graphs(gen, 1200, seed)
    _, rw = _workloads(queries)
    r_arrays = RTPSTry.from_workload(rw).compile(rg.label_names)
    part = hash_partition(g.n, k, seed=seed)
    for it in range(2):
        rf = r_field(rg, r_arrays, part, k, dense_ext_to=dense)
        fld = from_reference_arrays(
            field={f: getattr(rf, f) for f in RESULT_FIELDS}).field
        p_new, s_new = swap_iteration(g, part, fld, k, SwapConfig(),
                                      np.random.default_rng(0))
        p_ref, s_ref = r_swap_iteration(rg, part, rf, k, RSwapConfig(),
                                        np.random.default_rng(0))
        assert np.array_equal(p_new, p_ref), f"partition at iteration {it}"
        assert vars(s_new) == vars(s_ref), f"stats at iteration {it}"
        if s_new.moves == 0:
            break
        part = p_new


def test_lock_step_invocation():
    g, rg = _graphs("musicbrainz_like", 1500, 5)
    w, rw = _workloads(MQ, [0.2, 0.3, 0.5])
    arrays = TPSTry.from_workload(w).compile(g.label_names)
    r_arrays = RTPSTry.from_workload(rw).compile(rg.label_names)
    part = hash_partition(g.n, 8, seed=1)
    rng, r_rng = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(4):
        f = extroversion_field(g, arrays, part, 8, device="cpu")
        rf = r_field(rg, r_arrays, part, 8)
        for name in ("alpha", "pr", "edge_mass", "extro_mass", "extroversion",
                     "ext_to"):
            np.testing.assert_allclose(getattr(f, name), getattr(rf, name),
                                       rtol=1e-5, atol=1e-7, err_msg=name)
        p_new, stats = swap_iteration(g, part, f, 8, SwapConfig(), rng)
        p_ref, r_stats = r_swap_iteration(rg, part, rf, 8, RSwapConfig(), r_rng)
        assert np.array_equal(p_new, p_ref) and vars(stats) == vars(r_stats)
        if stats.moves == 0:
            break
        part = p_new


@pytest.mark.parametrize("name", sorted(FIG7))
def test_fig7_series_on_cpu(name):
    gen, seed, queries, freqs, series = FIG7[name]
    g = getattr(pgen, gen)(2000, avg_degree=6.0, seed=seed)
    w, rw = _workloads(queries, list(freqs))
    taper = Taper(g, 8, TaperConfig(max_iterations=8, seed=0), device="cpu")
    rep = taper.invoke(hash_partition(g.n, 8, seed=1), w)
    ex = QueryExecutor(g)
    got = [ex.workload_ipt(w, p) for p in rep.parts]
    assert rep.iterations == len(series) - 1
    assert [round(v) for v in got] == series
    assert len(rep.field_seconds) == rep.iterations + 1
    # ipt of the port's partitions, scored by the reference executor
    rg = getattr(rgen, gen)(2000, avg_degree=6.0, seed=seed)
    r_ex = RQueryExecutor(rg)
    assert [r_ex.workload_ipt(rw, p) for p in rep.parts] == got


@pytest.mark.parametrize("name", sorted(FIG7))
def test_workload_ipt_bitwise(name):
    gen, seed, queries, freqs, _ = FIG7[name]
    g, rg = _graphs(gen, 1500, seed)
    w, rw = _workloads(queries, list(freqs))
    ex, r_ex = QueryExecutor(g), RQueryExecutor(rg)
    for s in range(3):
        part = hash_partition(g.n, 8, seed=s)
        for (q, _), (rq, _) in zip(w, rw):
            assert np.array_equal(ex.traversals(q), r_ex.traversals(rq))
            assert ex.ipt(q, part) == r_ex.ipt(rq, part)
        assert ex.workload_ipt(w, part) == r_ex.workload_ipt(rw, part)


def test_taper_defaults_to_the_card():
    g = pgen.paper_example_graph()
    if torch.cuda.is_available():
        assert Taper(g, 2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            Taper(g, 2)


def test_invoke_on_a_tpstry_reuses_the_compiled_trie():
    """§4.2 lazy re-evaluation: an invocation given the TPSTry itself
    matches one given the workload, and a repeat field evaluation of an
    unchanged (trie, partition) pair is served from the memo."""
    gen, seed, queries, freqs, _ = FIG7["musicbrainz"]
    g = getattr(pgen, gen)(800, seed=seed)
    w, _ = _workloads(queries, list(freqs))
    start = hash_partition(g.n, 8, seed=1)
    taper = Taper(g, 8, device="cpu")
    trie = taper.build_trie(w)
    rep = taper.invoke(start, trie, max_iterations=2)
    ref = Taper(g, 8, device="cpu").invoke(start, w, max_iterations=2)
    assert all(np.array_equal(a, b) for a, b in zip(rep.parts, ref.parts))
    arrays = taper._arrays_cache
    taper.invoke(rep.final_part, trie, max_iterations=1)
    assert taper._arrays_cache is arrays                  # not recompiled
    f1 = taper.field(rep.final_part, arrays)
    assert taper.field(rep.final_part, arrays) is f1
