"""Cross-node observability on the port against the JAX package's.

Twins of ``tests/test_obs_cluster.py``: the failover drill leaves one
trace telling the whole story (primary crash, fence, promotion under epoch
2, first answer) in causal order; follower applies join shipped trace ids;
the failover dumps the flight recorder with the drill's events; one
registry pull sees every cluster component; the promoted loop takes over
the collector slots.  Each scenario runs through both packages (the port
with ``device="cpu"``), and the failover trace's spans and events, the
flight dumps and the registry's Prometheus text must be the reference's
with their time fields left out."""
import time

from test_torch_obs import shared_spans  # same-directory siblings
from test_torch_replication import _both, _cluster, _drive

#: span / event / dump keys that hold clock readings
TIME_KEYS = {"t", "t0", "t1", "wall", "duration_s"}


def _timeless(d):
    """A span, event or dump row without its clock readings (every ``*_s``
    attribute is a duration); the field span's rung named as the
    reference's (the port's ``torch`` is its ``jnp``)."""
    out = {k: v for k, v in d.items() if k not in TIME_KEYS and not k.endswith("_s")}
    if "attrs" in out:
        out["attrs"] = {k: (v.to_text() if hasattr(v, "to_text") else v)
                        for k, v in out["attrs"].items() if not k.endswith("_s")}
        if out["attrs"].get("backend") == "torch":
            out["attrs"]["backend"] = "jnp"
    return out


def _timeless_prometheus(text):
    """Prometheus lines without the timing metrics, the hedge counters and
    the reads served per follower (a hedge fires on a wall-clock deadline),
    and the rung's name."""
    keep = []
    for line in text.splitlines():
        name = line.split("{")[0].split(" ")[0]
        if (any(w in name for w in ("latency", "_s_", "wall", "capture", "publish", "hedge",
                                    "qps", "pressure", "age"))
                or name.endswith(("_s", "_served", "_rate"))):
            continue
        keep.append(line.replace('"torch"', '"jnp"'))
    return keep


def _obs(P, tmp, **kw):
    return P.obs.Observability(trace_sample_rate=1.0, node="cluster", **kw)


def _single_trace(P, tmp):
    obs = _obs(P, tmp, dump_dir=str(tmp / "flight"))
    coord = _cluster(P, tmp / "snap", n_followers=2, obs=obs, heartbeat_timeout_s=0.05)
    _drive(P, coord, rounds=18, seed=3)
    assert coord.primary.ot.invocations > 0  # the drill spans commits

    coord.crash_primary()
    time.sleep(0.06)
    coord.pump()
    assert coord.failovers == 1 and coord.hub.current_epoch == 2
    coord.serve([P.MQ3], cls="hot")  # the first post-failover answer

    roots = obs.tracer.spans(name="failover")
    assert len(roots) == 1, "the drill must open exactly ONE failover trace"
    tid = roots[0]["trace_id"]
    spans = obs.tracer.spans(tid)  # sorted by start time = causal order
    names = [s["name"] for s in spans]
    by_name = {s["name"]: s for s in spans}
    for expected in ("failover.primary-crash", "failover.fence", "failover.promotion",
                     "replica.commit", "failover.first-answer"):
        assert expected in names, f"{expected} missing from {names}"
    assert names.index("failover.primary-crash") < names.index("failover.fence") \
        < names.index("failover.promotion") < names.index("failover.first-answer")
    # the promotion happened under the advanced epoch
    assert by_name["failover.fence"]["attrs"]["epoch"] == 2
    assert by_name["failover.promotion"]["attrs"]["epoch"] == 2
    assert by_name["failover.promotion"]["attrs"]["slot"] == coord.primary_slot
    # every span is parented inside the one trace (no orphans)
    ids = {s["span_id"] for s in spans}
    root_id = roots[0]["span_id"]
    for s in spans:
        assert s["parent_id"] == 0 or s["parent_id"] in ids or s["parent_id"] == root_id
    # a second serve does NOT open another first-answer span
    coord.serve([P.MQ1], cls="hot")
    assert len(obs.tracer.spans(tid, name="failover.first-answer")) == 1
    coord.stop()
    return {"trace": [_timeless(s) for s in shared_spans(spans)],
            "all": [_timeless(s) for s in shared_spans(obs.tracer.spans())]}


def test_failover_drill_single_cross_node_trace(tmp_path):
    """Crash the primary, promote, answer a read: one failover trace whose
    spans tell that story in causal order, the follower's commit apply
    joined through the shipped frame's trace id — span for span the
    reference's, clocks aside."""
    _both(_single_trace, tmp_path)


def _auto_dump(P, tmp):
    obs = _obs(P, tmp, dump_dir=str(tmp / "flight"))
    coord = _cluster(P, tmp / "snap", n_followers=2, obs=obs, heartbeat_timeout_s=0.05)
    _drive(P, coord, rounds=6, seed=5)
    coord.crash_primary()
    time.sleep(0.06)
    coord.pump()
    assert coord.failovers == 1

    assert len(obs.recorder.dumps) == 1
    rows = P.obs.FlightRecorder.load_jsonl(obs.recorder.dumps[0])
    kinds = [r["kind"] for r in rows]
    assert "heartbeat_lapse" in kinds and "promotion" in kinds
    assert kinds.index("heartbeat_lapse") < kinds.index("promotion")
    assert kinds[-1] == "dump_trigger" and rows[-1]["reason"] == "failover"
    lapse = next(r for r in rows if r["kind"] == "heartbeat_lapse")
    assert lapse["silent_s"] >= 0.05 and lapse["slot"] == 0
    promo = next(r for r in rows if r["kind"] == "promotion")
    assert promo["epoch"] == 2 and promo["slot"] == coord.primary_slot
    assert promo["demoted_slot"] == 0
    coord.stop()
    return {"dump": obs.recorder.dumps[0].name, "rows": [_timeless(r) for r in rows]}


def test_failover_auto_dumps_flight_recorder(tmp_path):
    """Failover triggers a flight-recorder dump — heartbeat lapse, then
    promotion, then the dump — row for row the reference's."""
    _both(_auto_dump, tmp_path)


def _group_traces(P, tmp):
    obs = _obs(P, tmp)
    coord = _cluster(P, tmp, n_followers=1, obs=obs)
    for i in range(4):
        coord.submit_mutations(P.MutationBatch(add_edges=[(i, i + 1)]))
        coord.pump()
    groups = obs.tracer.spans(name="ingest.group")
    assert groups
    applies = obs.tracer.spans(name="replica.apply")
    assert applies
    group_tids = {s["trace_id"] for s in groups}
    for a in applies:
        assert a["trace_id"] in group_tids
        assert a["attrs"]["replica"] == "replica-1"
    # seq attrs line up: the follower applied the seqs the primary shipped
    assert {a["attrs"]["seq"] for a in applies} <= {g["attrs"]["seq"] for g in groups}
    coord.stop()
    return {"groups": [_timeless(s) for s in groups],
            "applies": [_timeless(s) for s in applies]}


def test_follower_applies_join_shipped_group_traces(tmp_path):
    _both(_group_traces, tmp_path)


def _registry(P, tmp):
    obs = _obs(P, tmp)
    coord = _cluster(P, tmp, n_followers=2, obs=obs)
    _drive(P, coord, rounds=8, seed=1)
    got = obs.registry.collected()
    for prefix in ("serve_", "executor_", "hub_", "follower_1_", "follower_2_", "router_",
                   "cluster_"):
        assert any(k.startswith(prefix) for k in got), f"no {prefix} keys in collected()"
    assert got["cluster_n_replicas"] == 3
    assert got["router_routed"] >= 8
    # per-SLO-class latency histograms populated by the router
    hot = obs.registry.histogram("router_latency_s", cls="hot")
    assert hot.count >= 8
    text = obs.registry.to_prometheus_text(include_collected=False)
    assert P.obs.parse_prometheus_text(text).to_prometheus_text(
        include_collected=False) == text
    out = {"keys": sorted(got), "hot_count": hot.count,
           "text": _timeless_prometheus(obs.registry.to_prometheus_text())}
    coord.stop()
    return out


def test_cluster_registry_collects_every_component(tmp_path):
    """One registry pull sees the loop, executor, hub, each follower, the
    router and the coordinator; the Prometheus export parses back and is
    the reference's, timing values aside."""
    _both(_registry, tmp_path)


def _collector_slots(P, tmp):
    obs = _obs(P, tmp)
    coord = _cluster(P, tmp, n_followers=2, obs=obs, heartbeat_timeout_s=0.05)
    _drive(P, coord, rounds=6, seed=2)
    coord.crash_primary()
    time.sleep(0.06)
    coord.pump()
    assert coord.failovers == 1
    promoted_slot = coord.primary_slot
    got = obs.registry.collected()
    assert not any(k.startswith(f"follower_{promoted_slot}_") for k in got)
    before = got["serve_completed"]
    coord.serve([P.MQ3], cls="hot")
    after = obs.registry.collected()
    assert after["serve_completed"] > before
    out = {"slot": promoted_slot, "keys": sorted(after),
           "completed": [before, after["serve_completed"]]}
    coord.stop()
    return out


def test_promoted_loop_takes_over_collector_slots(tmp_path):
    _both(_collector_slots, tmp_path)
