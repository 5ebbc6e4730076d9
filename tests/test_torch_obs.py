"""Observability on the port: tracer sampling and span trees, the flight
recorder ring and its JSONL dumps (at every fault site), the metrics
registry (collect protocol, Prometheus round trip) and the serving loop's
request / invocation / ingest traces.

Twins of ``tests/test_obs.py``: every scenario runs through
``repro_torch.obs`` and ``repro.obs`` (and both serving loops) in one
process on the same inputs, and the exports must be equal with their time
fields left out."""
import json

import numpy as np
import pytest

import repro.obs as R
import repro.serve.faults as RF
import repro_torch.obs as P
import repro_torch.serve.faults as PF
from repro.core.online import OnlinePolicy as ROnlinePolicy
from repro.core.rpq import parse_rpq as r_parse
from repro.core.taper import TaperConfig as RTaperConfig
from repro.graphs.generators import musicbrainz_like as r_musicbrainz
from repro.graphs.graph import MutationBatch as RMutationBatch
from repro.serve import ServeLoopConfig as RServeLoopConfig
from repro.serve import ServingLoop as RServingLoop
from repro.serve.metrics import ServeMetrics as RServeMetrics
from repro.serve.metrics import SlidingWindow as RSlidingWindow
from repro_torch.core.online import OnlinePolicy
from repro_torch.core.rpq import parse_rpq
from repro_torch.core.taper import TaperConfig
from repro_torch.graphs.generators import musicbrainz_like
from repro_torch.graphs.graph import MutationBatch
from repro_torch.serve import ServeLoopConfig, ServingLoop
from repro_torch.serve.metrics import ServeMetrics, SlidingWindow

MQ1, MQ3 = parse_rpq("Area.Artist.(Artist|Label).Area"), parse_rpq("Artist.Credit.Track.Medium")
R_MQ1, R_MQ3 = r_parse("Area.Artist.(Artist|Label).Area"), r_parse("Artist.Credit.Track.Medium")
SITES = ("SITE_INVOCATION", "SITE_SHARD_UPLOAD", "SITE_INGEST_GROUP", "SITE_SHIP_DROP",
         "SITE_SHIP_DELAY", "SITE_SHIP_REORDER", "SITE_LINK_PARTITION",
         "SITE_REPLICA_APPLY", "SITE_REPLICA_SERVE")
#: span / event keys that hold clock readings
TIME_KEYS = {"t", "t0", "t1", "wall", "duration_s"}


def shared_spans(spans):
    """The spans both packages record, their ids renumbered in order: the
    port's ``Taper.field`` also records its ``field.*`` spans, which the
    reference does not (``tests/test_torch_obs_field.py`` holds them)."""
    kept = sorted((s for s in spans if not s["name"].startswith("field.")),
                  key=lambda s: s["span_id"])
    ids = {s["span_id"]: i + 1 for i, s in enumerate(kept)}
    return [dict(s, span_id=ids[s["span_id"]],
                 parent_id=ids.get(s["parent_id"], s["parent_id"])) for s in kept]


def _timeless(d):
    """A span or event dict without its clock readings (top level and
    attributes: every ``*_s`` attribute is a duration)."""
    out = {k: v for k, v in d.items() if k not in TIME_KEYS}
    if "attrs" in out:
        # a query attribute is an RPQ of either package: compare its text
        out["attrs"] = {k: (v.to_text() if hasattr(v, "to_text") else v)
                        for k, v in out["attrs"].items() if not k.endswith("_s")}
    return out


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------


def _span_tree(mod):
    tr = mod.Tracer(node="a")
    ctx = tr.new_trace()
    assert ctx.sampled and ctx.trace_id.startswith("t-a-")
    with tr.start("root", ctx, kind="test") as root:
        child = tr.start("child", root.context())
        child.end(ok=True)
        tr.event("mark", root.context(), depth=2)
    return tr.spans(ctx.trace_id)


def test_tracer_span_tree_and_ring():
    spans = _span_tree(P)
    by_name = {s["name"]: s for s in spans}
    assert set(by_name) == {"root", "child", "mark"}
    assert by_name["child"]["parent_id"] == by_name["root"]["span_id"]
    assert by_name["mark"]["parent_id"] == by_name["root"]["span_id"]
    assert by_name["child"]["attrs"] == {"ok": True}
    assert by_name["mark"]["duration_s"] == 0.0
    assert by_name["root"]["duration_s"] >= 0.0 and by_name["root"]["wall"] > 0
    assert sorted(map(_timeless, spans), key=str) == \
        sorted(map(_timeless, _span_tree(R)), key=str)


@pytest.mark.parametrize("rate", [0.5, 0.25, 0.1])
def test_tracer_sampling_is_deterministic_counting(rate):
    got = {}
    for name, mod in (("port", P), ("ref", R)):
        tr = mod.Tracer(sample_rate=rate)
        got[name] = ([tr.new_trace().sampled for _ in range(20)],
                     tr.sampled_traces, tr.unsampled_traces)
        assert tr.start("x", mod.NOOP_TRACE) is mod.NOOP_SPAN
    assert got["port"] == got["ref"]
    if rate == 0.5:
        assert got["port"][0] == [True, False] * 10


def test_tracer_rate_zero_and_force():
    tr = P.Tracer(sample_rate=0.0)
    assert not tr.new_trace().sampled
    assert tr.new_trace(force=True).sampled
    off = P.Tracer(enabled=False)
    assert off.new_trace(force=True) is P.NOOP_TRACE


def test_tracer_join_adopts_foreign_trace():
    # a trace opened by the reference's tracer joins the port's, and back
    for a_mod, b_mod in ((R, P), (P, R)):
        a, b = a_mod.Tracer(node="a"), b_mod.Tracer(node="b")
        ctx = a.new_trace()
        a.start("origin", ctx).end()
        joined = b.join(ctx.trace_id)
        b.start("remote", joined).end()
        assert [s["name"] for s in b.spans(ctx.trace_id)] == ["remote"]
        assert b.join(None) is b_mod.NOOP_TRACE


def test_tracer_ring_eviction_and_jsonl_export(tmp_path):
    rows = {}
    for name, mod in (("port", P), ("ref", R)):
        tr = mod.Tracer(capacity=4)
        ctx = tr.new_trace()
        for i in range(10):
            tr.start(f"s{i}", ctx).end()
        assert [s["name"] for s in tr.spans()] == ["s6", "s7", "s8", "s9"]
        p = tmp_path / f"{name}.jsonl"
        assert tr.export_jsonl(p) == 4
        rows[name] = [_timeless(json.loads(line)) for line in p.read_text().splitlines()]
    assert [r["name"] for r in rows["port"]] == ["s6", "s7", "s8", "s9"]
    assert rows["port"] == rows["ref"]


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------


def test_recorder_ring_order_and_filter():
    evs = {}
    for name, mod in (("port", P), ("ref", R)):
        rec = mod.FlightRecorder(capacity=4)
        for i in range(6):
            rec.record("tick" if i % 2 else "tock", i=i)
        evs[name] = [_timeless(e) for e in rec.events()]
        assert [e["i"] for e in rec.events("tick")] == [3, 5]
    assert [e["i"] for e in evs["port"]] == [2, 3, 4, 5]
    assert all(e["node"] == "n0" for e in evs["port"])
    assert evs["port"] == evs["ref"]


def test_recorder_trigger_dumps_jsonl(tmp_path):
    rows = {}
    for name, mod in (("port", P), ("ref", R)):
        rec = mod.FlightRecorder(dump_dir=tmp_path / name, node="p")
        rec.record("admission_reject", reason="queue_full")
        path = rec.trigger("failover")
        assert path is not None and path.exists() and rec.dumps == [path]
        rows[name] = [_timeless(r) for r in mod.FlightRecorder.load_jsonl(path)]
        assert path.name == "flight-p-0001.jsonl"
    assert rows["port"][0]["kind"] == "admission_reject"
    assert rows["port"][-1] == {"seq": 2, "node": "p", "kind": "dump_trigger",
                                "reason": "failover"}
    assert rows["port"] == rows["ref"]


def test_recorder_env_dump_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_FLIGHT_DIR", str(tmp_path / "flight"))
    assert P.FLIGHT_DIR_ENV == R.FLIGHT_DIR_ENV
    rec = P.FlightRecorder()
    rec.record("x")
    assert rec.trigger("t").exists()


def test_recorder_disabled_is_inert(tmp_path):
    rec = P.FlightRecorder(dump_dir=tmp_path, enabled=False)
    rec.record("x")
    assert rec.trigger("t") is None
    assert rec.events() == [] and rec.dumps == []


def test_every_fault_site_triggers_a_flight_dump(tmp_path):
    """Each armed fault site (scoped per-replica arms included) records a
    ``fault_fired`` event and dumps the ring, as the reference does."""
    assert [getattr(PF, s) for s in SITES] == [getattr(RF, s) for s in SITES]
    for i, site in enumerate(getattr(PF, s) for s in SITES):
        dumped = {}
        for name, faults, obs in (("port", PF, P), ("ref", RF, R)):
            fi = faults.FaultInjector()
            fi.recorder = obs.FlightRecorder(dump_dir=tmp_path / name / site, node=site)
            scoped = site if i % 2 == 0 else f"{site}:replica-1"
            fi.arm(scoped, mode="raise", times=1)
            with pytest.raises(faults.InjectedFault):
                fi.fire(scoped)
            ev = fi.recorder.events("fault_fired")
            assert len(ev) == 1 and ev[0]["site"] == scoped
            assert fi.recorder.events("dump_trigger")[0]["reason"] == f"fault:{scoped}"
            assert len(fi.recorder.dumps) == 1
            dumped[name] = [_timeless(r) for r in
                            obs.FlightRecorder.load_jsonl(fi.recorder.dumps[0])]
        assert any(r["kind"] == "fault_fired" for r in dumped["port"])
        assert dumped["port"] == dumped["ref"]


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


def _instruments(mod):
    reg = mod.Registry()
    c = reg.counter("requests_total", cls="hot")
    c.inc()
    c.inc(2)
    assert reg.counter("requests_total", cls="hot") is c
    reg.gauge("queue_depth").set(7)
    h = reg.histogram("latency_s")
    for v in (0.001, 0.003, 0.2):
        h.observe(v)
    with pytest.raises(TypeError):
        reg.gauge("requests_total", cls="hot")
    return reg


def test_registry_instruments():
    reg = _instruments(P)
    snap = reg.snapshot()
    assert snap["requests_total_cls_hot"] == 3 and snap["queue_depth"] == 7
    assert snap["latency_s_count"] == 3
    assert snap["latency_s_sum"] == pytest.approx(0.204)
    assert 0 < snap["latency_s_p50"] <= snap["latency_s_p99"]
    ref = _instruments(R)
    assert snap == ref.snapshot()
    assert reg.to_prometheus_text() == ref.to_prometheus_text()


def _prometheus(mod):
    reg = mod.Registry()
    reg.counter("reqs_total", cls="hot").inc(5)
    reg.counter("reqs_total", cls="cold").inc(1)
    reg.gauge("depth").set(3.5)
    h = reg.histogram("lat_s", cls="hot")
    for v in (0.0001, 0.004, 0.09, 30.0):
        h.observe(v)
    return reg


def test_registry_prometheus_round_trip():
    reg = _prometheus(P)
    text = reg.to_prometheus_text(include_collected=False)
    again = P.parse_prometheus_text(text)
    assert again.to_prometheus_text(include_collected=False) == text
    assert again.snapshot() == reg.snapshot()
    # the reference's export of the same operations, byte for byte, and
    # each package parses the other's text
    assert _prometheus(R).to_prometheus_text(include_collected=False) == text
    assert R.parse_prometheus_text(text).to_prometheus_text(include_collected=False) == text


def test_registry_collect_protocol():
    reg = P.Registry()
    reg.register_collector("serve", lambda: {
        "completed": 10, "nested": {"a": 1, "b": 2.5}, "name": "skip-me",
        "flag": True})
    assert reg.collected() == {"serve_completed": 10, "serve_nested_a": 1,
                               "serve_nested_b": 2.5, "serve_flag": 1}
    reg.register_collector("serve", lambda: {"completed": 11})
    assert reg.collected() == {"serve_completed": 11}
    reg.register_collector("bad", lambda: 1 / 0)
    assert reg.collected() == {"serve_completed": 11}
    reg.unregister_collector("serve")
    reg.unregister_collector("bad")
    assert reg.collected() == {}


def test_flatten_numeric():
    d = {"a": 1, "b": {"c": 2.0, "d": {"e": 3}}, "s": "x", "t": True, "l": [1]}
    assert P.flatten_numeric(d) == {"a": 1, "b_c": 2.0, "b_d_e": 3, "t": 1}
    assert P.flatten_numeric(d) == R.flatten_numeric(d)


# ---------------------------------------------------------------------------
# serve metrics
# ---------------------------------------------------------------------------


def test_sliding_window_percentile_cache_matches_fresh_sort():
    rng = np.random.default_rng(0)
    w, rw = SlidingWindow(window=64), RSlidingWindow(window=64)
    for i, v in enumerate(rng.random(200)):
        w.record(float(v))
        rw.record(float(v))
        if i % 7 == 0:
            for p in (0.0, 50.0, 90.0, 99.0, 100.0):
                fresh = sorted(w._buf)
                idx = min(len(fresh) - 1, max(0, int(round(p / 100.0 * (len(fresh) - 1)))))
                assert w.percentile(p) == fresh[idx]
                assert w.percentile(p) == fresh[idx] == rw.percentile(p)


def test_serve_metrics_snapshot_is_flat_scalars():
    snaps = []
    for metrics in (ServeMetrics, RServeMetrics):
        m = metrics(window=16)
        m.record_batch([0.01, 0.02], [1, 2], False, worker_id=0)
        m.record_batch([0.03], [3], True, worker_id=2)
        snaps.append(m.snapshot(field_stats={"halo_ratio": 0.25}))
    snap = snaps[0]
    for k, v in snap.items():
        assert not isinstance(v, (dict, list, tuple)), k
    assert snap["completed_by_worker_0"] == 2 and snap["completed_by_worker_2"] == 1
    assert snap["workers_reporting"] == 2 and snap["halo_ratio"] == 0.25
    assert "completed_by_worker" not in snap
    assert snap == snaps[1]


# ---------------------------------------------------------------------------
# serving loop integration (both packages, one stream)
# ---------------------------------------------------------------------------


def _loops(tmp=None, obs=(None, None), **pol):
    """The port's loop (CPU) and the reference's, built alike."""
    pol.setdefault("bootstrap_after_ticks", 0)
    pol.setdefault("cadence", 6)
    pol.setdefault("min_interval", 0)
    pol.setdefault("dirty_fraction", 0.02)
    pol.setdefault("drift_l1", 9e9)
    pol.setdefault("ipt_regression", 9e9)
    port = ServingLoop(
        musicbrainz_like(300, seed=7), 4, taper_config=TaperConfig(max_iterations=2),
        policy=OnlinePolicy(**pol),
        config=ServeLoopConfig(micro_batch=8, overlap_invocations=False, obs=obs[0],
                               snapshot_dir=None if tmp is None else str(tmp / "port")),
        device="cpu")
    ref = RServingLoop(
        r_musicbrainz(300, seed=7), 4, taper_config=RTaperConfig(max_iterations=2),
        policy=ROnlinePolicy(**pol),
        config=RServeLoopConfig(micro_batch=8, overlap_invocations=False, obs=obs[1],
                                snapshot_dir=None if tmp is None else str(tmp / "ref")))
    return port, ref


def _drive(loop, rounds, q1, q3, batch, mutate_every=3):
    tickets = []
    for i in range(rounds):
        t = loop.submit(q1 if i % 3 else q3)
        assert t.accepted
        tickets.append(t)
        if mutate_every and i % mutate_every == 0:
            loop.submit_mutations(batch(add_edges=[(i % 200, (i * 7) % 200)]))
        loop.pump()
    while not all(t.done.is_set() for t in tickets):
        loop.pump()


def _drive_both(port, ref, rounds, **kw):
    _drive(port, rounds, MQ1, MQ3, MutationBatch, **kw)
    _drive(ref, rounds, R_MQ1, R_MQ3, RMutationBatch, **kw)


def test_loop_request_and_invocation_traces(tmp_path):
    obs = (P.Observability(trace_sample_rate=1.0, node="primary"),
           R.Observability(trace_sample_rate=1.0, node="primary"))
    port, ref = _loops(tmp_path, obs=obs)
    _drive_both(port, ref, rounds=14)
    assert port.ot.invocations >= 1
    tr = obs[0].tracer
    reqs = tr.spans(name="request")
    assert len(reqs) == 14
    assert all(r["attrs"]["latency_s"] > 0 and "n_paths" in r["attrs"] for r in reqs)
    batches = tr.spans(name="request.batch")
    assert batches and all(b["trace_id"].startswith("t-primary-") for b in batches)
    assert {b["trace_id"] for b in batches} <= {r["trace_id"] for r in reqs}
    inv = [s for s in tr.spans(name="invocation") if s["attrs"].get("committed")]
    assert inv
    names = [s["name"] for s in tr.spans(inv[0]["trace_id"])]
    for stage in ("invocation.snapshot", "invocation.field", "invocation.swap",
                  "invocation.commit"):
        assert stage in names, f"{stage} missing from {names}"
    assert names.index("invocation.snapshot") < names.index("invocation.commit")
    assert tr.spans(name="ingest.group")
    # the same spans as the reference's loop, trace by trace, clocks aside
    # (the field span names its rung: the port's "torch" for the jnp rung)
    def spans_of(tracer, rename=None):
        out = []
        for s in shared_spans(tracer.spans()):
            s = _timeless(s)
            if rename and s["attrs"].get("backend") in rename:
                s["attrs"]["backend"] = rename[s["attrs"]["backend"]]
            out.append(s)
        return out
    assert spans_of(tr) == spans_of(obs[1].tracer, {"jnp": "torch"})
    port.stop()
    ref.stop()


def test_loop_trace_sample_rate_config_path():
    port, ref = _loops()
    assert not port.obs.enabled and port.obs is P.Observability.disabled()
    port.stop()
    ref.stop()
    loop = ServingLoop(
        musicbrainz_like(300, seed=7), 4, taper_config=TaperConfig(max_iterations=2),
        policy=OnlinePolicy(bootstrap_after_ticks=0, cadence=6, min_interval=0,
                            dirty_fraction=0.02, drift_l1=9e9, ipt_regression=9e9),
        config=ServeLoopConfig(micro_batch=8, overlap_invocations=False,
                               trace_sample_rate=0.25),
        device="cpu")
    assert loop.obs.enabled and loop.obs.tracer.sample_rate == 0.25
    loop.stop()


def _timeless_prometheus(text):
    """Prometheus lines without the timing metrics' values."""
    keep = []
    for line in text.splitlines():
        name = line.split("{")[0].split(" ")[0]
        if any(w in name for w in ("latency", "_s_", "wall", "capture", "publish")) \
                or name.endswith("_s"):
            continue
        keep.append(line)
    return keep


def test_loop_registers_collectors_and_prom_export(tmp_path):
    obs = (P.Observability(trace_sample_rate=1.0), R.Observability(trace_sample_rate=1.0))
    port, ref = _loops(tmp_path, obs=obs)
    _drive_both(port, ref, rounds=8)
    got = obs[0].registry.collected()
    assert any(k.startswith("serve_") for k in got)
    assert got["executor_enum_calls"] > 0 and got["executor_plans_compiled"] > 0
    reg = obs[0].registry
    text = reg.to_prometheus_text()
    assert P.parse_prometheus_text(reg.to_prometheus_text(include_collected=False)) \
        .to_prometheus_text(include_collected=False) \
        == reg.to_prometheus_text(include_collected=False)
    assert "executor_enum_calls" in text
    # the same export as the reference's loop, timing values left out
    executor = {k: v for k, v in got.items() if k.startswith("executor_")}
    assert executor == {k: v for k, v in obs[1].registry.collected().items()
                        if k.startswith("executor_")}
    assert _timeless_prometheus(text) == _timeless_prometheus(
        obs[1].registry.to_prometheus_text())
    port.stop()
    ref.stop()


def test_loop_fault_site_dump_through_serving_path(tmp_path):
    rows = {}
    for name, obs_mod, faults, loop_cls, cfg_cls, pol_cls, tc_cls, gen, batch, kw in (
            ("port", P, PF, ServingLoop, ServeLoopConfig, OnlinePolicy, TaperConfig,
             musicbrainz_like, MutationBatch, {"device": "cpu"}),
            ("ref", R, RF, RServingLoop, RServeLoopConfig, ROnlinePolicy, RTaperConfig,
             r_musicbrainz, RMutationBatch, {})):
        fi = faults.FaultInjector()
        obs = obs_mod.Observability(trace_sample_rate=1.0,
                                    dump_dir=str(tmp_path / name / "flight"))
        loop = loop_cls(
            gen(300, seed=7), 4, taper_config=tc_cls(max_iterations=2),
            policy=pol_cls(bootstrap_after_ticks=10 ** 9, cadence=10 ** 9, min_interval=0,
                           dirty_fraction=2.0, drift_l1=9e9, ipt_regression=9e9),
            config=cfg_cls(micro_batch=8, overlap_invocations=False, obs=obs, faults=fi,
                           snapshot_dir=str(tmp_path / name / "snap")), **kw)
        fi.arm(faults.SITE_INGEST_GROUP, mode="raise", times=1)
        loop.submit_mutations(batch(add_edges=[(1, 2)]))
        loop.pump()
        assert fi.recorder is obs.recorder
        assert [e["site"] for e in obs.recorder.events("fault_fired")] \
            == [faults.SITE_INGEST_GROUP]
        assert len(obs.recorder.dumps) == 1
        rows[name] = [_timeless(r) for r in
                      obs_mod.FlightRecorder.load_jsonl(obs.recorder.dumps[0])]
        loop.stop()
    assert any(r["kind"] == "fault_fired" for r in rows["port"])
    assert rows["port"] == rows["ref"]


def test_obs_disabled_leaves_no_trace_state(tmp_path):
    port, ref = _loops(tmp_path)
    _drive(port, 6, MQ1, MQ3, MutationBatch)
    assert port.obs.tracer.spans() == [] and port.obs.recorder.events() == []
    port.stop()
    ref.stop()


def test_histogram_quantile_round_trips_sliding_window():
    """The registry histogram's bucket quantile and the serving metrics'
    exact percentile agree to bucket resolution on the same samples, and
    both equal the reference's."""
    import bisect

    rng = np.random.default_rng(42)
    h, rh = P.Registry().histogram("lat", cls="hot"), R.Registry().histogram("lat", cls="hot")
    sw = SlidingWindow(window=4096)
    for x in rng.uniform(0.0008, 1.2, size=600):
        h.observe(float(x))
        rh.observe(float(x))
        sw.record(float(x))
    for q in (0.5, 0.9, 0.95, 0.99):
        exact, est = sw.percentile(q * 100.0), h.quantile(q)
        i = bisect.bisect_left(h.bounds, exact)
        lo = h.bounds[i - 2] if i >= 2 else 0.0
        hi = h.bounds[min(i + 1, len(h.bounds) - 1)]
        assert lo <= est <= hi, (q, exact, est)
        assert est == rh.quantile(q)


def test_recorder_wraparound_retains_exactly_the_window(tmp_path):
    dumps = {}
    for name, mod in (("port", P), ("ref", R)):
        rec = mod.FlightRecorder(capacity=8, dump_dir=tmp_path / name, node="soak")
        for i in range(50):
            rec.record("tick", i=i)
        assert rec.recorded == 50
        evs = rec.events()
        assert [e["i"] for e in evs] == list(range(42, 50))
        assert [e["seq"] for e in evs] == sorted(e["seq"] for e in evs)
        rows = mod.FlightRecorder.load_jsonl(rec.trigger("soak-check"))
        assert len(rows) == 8
        assert [r["i"] for r in rows[:-1]] == list(range(43, 50))
        assert rows[-1]["kind"] == "dump_trigger" and rows[-1]["reason"] == "soak-check"
        dumps[name] = [_timeless(r) for r in rows]
    assert dumps["port"] == dumps["ref"]
