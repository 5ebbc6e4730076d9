"""The paper's figures 8-11 and the online-topology series, run through the
port on the CPU at N=2000, against the committed ``BENCH_PR10.json``.

Each function below follows its benchmark (``benchmarks/fig8_approaches.py``,
``fig9_queries.py``, ``fig10_drift.py``, ``fig11_online.py``,
``online_topology.py``) step for step with the port's modules, at
``benchmarks/common.py``'s settings (k=8, hash seed 1, metis-like seed 0,
``max_iterations=8``, seed 0), and the ``derived`` strings must equal the
file's exactly; the online series' wall-clock fields are left out.  The
file is read, never written."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch.core.online import OnlinePolicy, OnlineTaper
from repro_torch.core.rpq import parse_rpq
from repro_torch.core.taper import Taper, TaperConfig
from repro_torch.graphs.generators import musicbrainz_like, provgen_like
from repro_torch.graphs.partition import (fennel_stream_partition, hash_partition,
                                          metis_like_partition)
from repro_torch.workload.executor import QueryExecutor
from repro_torch.workload.sketch import FrequencySketch
from repro_torch.workload.stream import (GraphMutationStream, WorkloadStream,
                                         linear_drift)

BENCH = Path(__file__).resolve().parent.parent / "BENCH_PR10.json"
N, K = 2000, 8
MQ = {"MQ1": parse_rpq("Area.Artist.(Artist|Label).Area"),
      "MQ2": parse_rpq("Artist.Credit.(Track|Recording).Credit.Artist"),
      "MQ3": parse_rpq("Artist.Credit.Track.Medium")}
PQ = {"PQ1": parse_rpq("Entity.(Entity)*.Entity"),
      "PQ2": parse_rpq("Agent.Activity.Entity.Entity.Activity.Agent"),
      "PQ3": parse_rpq("(Entity)*.Activity.Entity"),
      "PQ4": parse_rpq("Entity.Activity.(Agent)*")}
#: the wall-clock fields of the online series, left out of the comparison
TIMED = ("maint_incr_ms=", "maint_rebuild_ms=", "incremental_vs_rebuild_speedup=")


@pytest.fixture(scope="module")
def expected():
    data = json.loads(BENCH.read_text())
    assert data["bench_n"] == N and data["k"] == K
    return {r["name"]: r["derived"] for r in data["rows"]}


def _dataset(name):
    if name == "musicbrainz":
        return musicbrainz_like(N, avg_degree=6.0, seed=13)
    return provgen_like(N, avg_degree=6.0, seed=11)


def _workload(name):
    if name == "musicbrainz":
        return list(zip(MQ.values(), (0.2, 0.3, 0.5)))
    return list(zip(PQ.values(), (0.4, 0.2, 0.2, 0.2)))


def _taper(g, **overrides):
    kwargs = {"max_iterations": 8, "seed": 0}
    kwargs.update(overrides)
    return Taper(g, K, TaperConfig(**kwargs), device="cpu")


def _time_free(derived):
    return " ".join(f for f in derived.split() if not f.startswith(TIMED))


def _check(rows, expected, prefix):
    names = sorted(n for n in expected if n.startswith(prefix))
    assert sorted(rows) == names
    for name in names:
        assert rows[name] == _time_free(expected[name]), name


@pytest.mark.parametrize("name", ["provgen", "musicbrainz"])
def test_fig8_approaches(name, expected):
    g, w = _dataset(name), _workload(name)
    ex = QueryExecutor(g)
    starts = {"hash": hash_partition(g.n, K, seed=1),
              "metis": metis_like_partition(g, K, seed=0),
              "fennel": fennel_stream_partition(g, 8, seed=0)}
    rows, ipts = {}, {}
    for sname, part in starts.items():
        ipts[sname] = ex.workload_ipt(w, part)
        rows[f"fig8/{name}/{sname}"] = f"ipt={ipts[sname]:.0f}"
    taper = _taper(g)
    for sname, part in starts.items():
        rep = taper.invoke(part, w)
        ipt = ex.workload_ipt(w, rep.final_part)
        rows[f"fig8/{name}/{sname}+taper"] = (
            f"ipt={ipt:.0f} reduction={1 - ipt / max(ipts[sname], 1e-9):.1%} "
            f"iters={rep.iterations} moves={rep.total_moves}")
    _check(rows, expected, f"fig8/{name}/")


def test_fig9_queries(expected):
    freqs = {"MQ1": 0.1, "MQ2": 0.2, "MQ3": 0.7}
    g = _dataset("musicbrainz")
    ex = QueryExecutor(g)
    hash_p, metis_p = hash_partition(g.n, K, seed=1), metis_like_partition(g, K, seed=0)
    taper = _taper(g)
    w_skew = [(MQ[n], freqs[n]) for n in ("MQ1", "MQ2", "MQ3")]
    w_rev = [(MQ["MQ1"], 0.7), (MQ["MQ2"], 0.2), (MQ["MQ3"], 0.1)]
    part_skew = taper.invoke(metis_p, w_skew).final_part
    part_rev = taper.invoke(metis_p, w_rev).final_part
    rows = {}
    for qname, q in MQ.items():
        ipt_h, ipt_m, ipt_t = ex.ipt(q, hash_p), ex.ipt(q, metis_p), ex.ipt(q, part_skew)
        rows[f"fig9/{qname}"] = (
            f"freq={freqs[qname]:.0%} ipt_hash={ipt_h:.0f} ipt_metis={ipt_m:.0f} "
            f"ipt_metis+taper={ipt_t:.0f} vs_metis={ipt_t / max(ipt_m, 1e-9):.2f}")
    mq1 = ex.ipt(MQ["MQ1"], part_rev) <= ex.ipt(MQ["MQ1"], part_skew)
    mq3 = ex.ipt(MQ["MQ3"], part_skew) <= ex.ipt(MQ["MQ3"], part_rev)
    rows["fig9/frequency_mechanism"] = (f"mq1_better_under_mq1heavy={mq1} "
                                        f"mq3_better_under_mq3heavy={mq3}")
    _check(rows, expected, "fig9/")


def test_fig10_drift(expected):
    qa, qb, steps = parse_rpq("Entity.Entity"), parse_rpq("Agent.Activity"), 6
    g = _dataset("provgen")
    ex = QueryExecutor(g)
    hash_p = hash_partition(g.n, K, seed=1)
    taper = _taper(g)
    fitted_a = taper.invoke(hash_p, [(qa, 1.0)]).final_part
    fitted_b = taper.invoke(hash_p, [(qb, 1.0)]).final_part
    ipt_b_hash = ex.ipt(qb, hash_p)
    rows = {"fig10/ref_hash": f"ipt_Qb_over_hash={ipt_b_hash:.0f}",
            "fig10/ref_fitted": f"ipt_Qb_over_fitted={ex.ipt(qb, fitted_b):.0f}"}
    ratios = []
    for i in range(steps + 1):
        fa, fb = linear_drift(i / steps)
        w = [(qa, fa), (qb, fb)]
        ipt, ipt_hash = ex.workload_ipt(w, fitted_a), ex.workload_ipt(w, hash_p)
        ratios.append(ipt / max(ipt_hash, 1e-9))
        rows[f"fig10/t{i}"] = (f"freq_Qb={fb:.2f} ipt={ipt:.0f} ipt_hash={ipt_hash:.0f} "
                               f"vs_hash={ratios[-1]:.3f}")
    restorable = ex.ipt(qb, fitted_b) / max(ipt_b_hash, 1e-9)
    rows["fig10/degradation"] = (
        f"vs_hash_start={ratios[0]:.3f} vs_hash_end={ratios[-1]:.3f} "
        f"restorable_floor={restorable:.3f} degraded={ratios[-1] > ratios[0] * 1.5}")
    _check(rows, expected, "fig10/")


def test_fig11_online(expected):
    ticks, every, batch = 12, 4, 400
    g = _dataset("musicbrainz")
    ex = QueryExecutor(g)
    hash_p = hash_partition(g.n, K, seed=1)
    taper = _taper(g, max_iterations=4)
    stream = WorkloadStream(list(MQ.values()), period=float(ticks), seed=3)
    sketch = FrequencySketch(half_life=2.0)
    part = taper.invoke(hash_p, stream.workload()).final_part
    rows, drops, invocations = {}, 0, 0
    for tick in range(ticks):
        stream.advance(1.0)
        sketch.observe_batch(stream.sample(batch))
        w_true = stream.workload()
        ipt_now = ex.workload_ipt(w_true, part)
        ipt_hash = ex.workload_ipt(w_true, hash_p)
        invoked = ""
        if (tick + 1) % every == 0:
            part = taper.invoke(part, sketch.workload()).final_part
            invocations += 1
            ipt_after = ex.workload_ipt(w_true, part)
            drops += ipt_after < ipt_now
            invoked = f" invoked ipt_after={ipt_after:.0f}"
            ipt_now = ipt_after
        rows[f"fig11/tick{tick}"] = (f"ipt={ipt_now:.0f} hash_baseline={ipt_hash:.0f} "
                                     f"below_baseline={ipt_now < ipt_hash}{invoked}")
    rows["fig11/summary"] = f"invocations={invocations} drops_after_invocation={drops}"
    _check(rows, expected, "fig11/")


def test_online_topology(expected):
    """benchmarks/online_topology.py: an OnlineTaper over a mixed mutation
    stream; the executor's counts are patched tick by tick."""
    ticks, batch = 10, 300
    g = _dataset("musicbrainz").copy()
    queries = list(MQ.values())
    ex = QueryExecutor(g)
    stream = WorkloadStream(queries, period=float(ticks), seed=3)
    muts = GraphMutationStream(mode="mixed", seed=7,
                               vertices_per_tick=max(2, g.n // 2000),
                               edges_per_tick=max(8, g.m // 2000))
    taper0 = _taper(g, max_iterations=4)
    part0 = taper0.invoke(hash_partition(g.n, K, seed=1), stream.workload()).final_part
    online = OnlineTaper(g, K, part=part0, config=taper0.config, device="cpu",
                         policy=OnlinePolicy(cadence=4, dirty_fraction=0.05,
                                             drift_l1=0.35))
    online.observe(stream.sample(batch))
    for q in queries:
        ex.traversals(q)
    rows, below = {}, 0
    for tick in range(ticks):
        stream.advance(1.0)
        online.observe(stream.sample(batch))
        applied = g.apply_mutations(muts.next_batch(g))
        g.reverse_edge_index
        g.cached_neighbor_label_counts()
        for q in queries:
            ex.traversals(q)
        online.ingest(applied)
        w_true = stream.workload()
        ipt_now = ex.workload_ipt(w_true, online.part)
        step = online.step(measured_ipt=ipt_now)
        if step.invoked:
            ipt_now = ex.workload_ipt(w_true, online.part)
        ipt_hash = ex.workload_ipt(w_true, hash_partition(g.n, K, seed=1))
        below += ipt_now < ipt_hash
        rows[f"online_topology/tick{tick}"] = (
            f"n={g.n} m={g.m} ipt={ipt_now:.0f} hash_baseline={ipt_hash:.0f} "
            f"below_baseline={ipt_now < ipt_hash} "
            f"invoked={step.invoked} reason={step.reason or '-'}")
    rows["online_topology/summary"] = (
        f"ticks={ticks} below_baseline={below}/{ticks} "
        f"invocations={online.invocations} all_below_baseline={below == ticks}")
    _check(rows, expected, "online_topology/")
    for q in queries:   # the patched counts equal a rebuild's
        assert np.array_equal(ex.traversals(q), QueryExecutor(g).traversals(q))
