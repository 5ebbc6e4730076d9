"""The port's serving pieces against the JAX package's: the admission and
ingest queues, ``coalesce_mutations``, the serve metrics, the control loops
(``serve/control.py``) and the fault injector with the loop's degradation
paths that need no CUDA field.

Twins of ``tests/test_serve_loop.py``'s queue and coalescing tests, of
``tests/test_control.py`` (all but the ship-channel test, which waits for
the cluster slice) and of ``tests/test_faults.py`` (the backend-ladder and
shard-upload twins need the ``cuda`` field and live in
``tests/test_torch_cuda.py``).  Each scenario runs through both packages
(``_both``) on the same inputs; what it observes must be equal."""
import functools
import threading
import time
import types

import numpy as np
import pytest

import repro.core.online as r_online
import repro.core.rpq as r_rpq
import repro.core.taper as r_taper
import repro.graphs.generators as r_gen
import repro.graphs.graph as r_graph
import repro.obs.registry as r_registry
import repro.serve as r_serve
import repro.serve.control as r_control
import repro.serve.faults as r_faults
import repro.serve.queueing as r_queueing
import repro_torch.core.online as p_online
import repro_torch.core.rpq as p_rpq
import repro_torch.core.taper as p_taper
import repro_torch.graphs.generators as p_gen
import repro_torch.graphs.graph as p_graph
import repro_torch.obs.registry as p_registry
import repro_torch.serve as p_serve
import repro_torch.serve.control as p_control
import repro_torch.serve.faults as p_faults
import repro_torch.serve.queueing as p_queueing
from repro_torch.kernels import KernelError


def _ns(online, rpq, taper, gen, graph, registry, serve, control, faults, queueing,
        loop_kw):
    ns = types.SimpleNamespace()
    for mod in (control, faults, queueing):
        ns.__dict__.update({k: v for k, v in vars(mod).items() if not k.startswith("__")})
    ns.OnlinePolicy, ns.OnlineTaper = online.OnlinePolicy, online.OnlineTaper
    ns.parse_rpq, ns.TaperConfig = rpq.parse_rpq, taper.TaperConfig
    ns.musicbrainz_like, ns.power_law_labelled = gen.musicbrainz_like, gen.power_law_labelled
    ns.MutationBatch, ns.Registry = graph.MutationBatch, registry.Registry
    ns.IngestQueue, ns.coalesce_mutations = serve.IngestQueue, serve.coalesce_mutations
    ns.ServeLoopConfig = serve.ServeLoopConfig
    ns.ServingLoop = functools.partial(serve.ServingLoop, **loop_kw)
    ns.OnlineTaper = functools.partial(online.OnlineTaper, **loop_kw)
    ns.restore = functools.partial(serve.ServingLoop.restore, **loop_kw)
    ns.MQ1 = rpq.parse_rpq("Area.Artist.(Artist|Label).Area")
    ns.MQ3 = rpq.parse_rpq("Artist.Credit.Track.Medium")
    return ns


PORT = _ns(p_online, p_rpq, p_taper, p_gen, p_graph, p_registry, p_serve, p_control,
           p_faults, p_queueing, {"device": "cpu"})
REF = _ns(r_online, r_rpq, r_taper, r_gen, r_graph, r_registry, r_serve, r_control,
          r_faults, r_queueing, {})


def _both(scenario, *args):
    """Run ``scenario(ns, *args)`` on the port and on the reference; their
    observations must be equal.  Returns the port's."""
    got = scenario(PORT, *args)
    assert got == scenario(REF, *args)
    return got


def _both_backend(scenario, *args):
    """``_both`` for scenarios whose observations name the field rung: the
    port's ``torch`` rung is the reference's ``jnp``."""
    got, ref = scenario(PORT, *args), scenario(REF, *args)
    swap = {"jnp": "torch"}
    assert got == tuple(swap.get(x, x) if isinstance(x, str) else x for x in ref)
    return got


class FakeClock:
    def __init__(self, t0=0.0):
        self.t = float(t0)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class ListRecorder:
    def __init__(self):
        self.events = []

    def record(self, kind, **fields):
        self.events.append({"kind": kind, **fields})

    def of(self, kind):
        return [e for e in self.events if e["kind"] == kind]


# ---------------------------------------------------------------------------
# request queue
# ---------------------------------------------------------------------------


def _backpressure(m):
    q = m.RequestQueue(max_depth=4)
    assert all(q.submit(m.MQ1).accepted for _ in range(4))
    rej = q.submit(m.MQ1)
    assert not rej.accepted and rej.reason == "queue_full" and rej.queue_depth == 4
    assert rej.retry_after_s > 0 and q.rejected == 1
    q.record_service_time(1.0)
    slow = q.submit(m.MQ1)
    assert slow.retry_after_s > rej.retry_after_s
    q.take_batch(2)
    return rej.retry_after_s, slow.retry_after_s, q.submit(m.MQ1).accepted


def test_request_queue_backpressure_rejects_with_retry_hint():
    assert _both(_backpressure)[2]


def _reserve(m):
    freqs = {m.MQ1.qhash: 0.9, m.MQ3.qhash: 0.02}
    q = m.RequestQueue(max_depth=8, hot_reserve_frac=0.5,
                       admission_weight=lambda rpq: freqs[rpq.qhash])
    for _ in range(4):
        assert q.submit(m.MQ1).accepted
    cold = q.submit(m.MQ3)
    assert not cold.accepted and cold.reason == "cold_backpressure"
    assert q.rejected_cold == 1 and q.submit(m.MQ1).accepted
    for _ in range(3):
        q.submit(m.MQ1)
    hot_rej, cold_rej = q.submit(m.MQ1), q.submit(m.MQ3)
    assert not hot_rej.accepted and not cold_rej.accepted
    assert hot_rej.reason == "queue_full"
    assert hot_rej.retry_after_s < cold_rej.retry_after_s
    return cold.retry_after_s, hot_rej.retry_after_s, cold_rej.retry_after_s


def test_admission_classes_reserve_admits_hot_ahead_of_cold():
    _both(_reserve)


def _inactive(m):
    q = m.RequestQueue(max_depth=2)
    assert q.submit(m.MQ1).accepted and q.submit(m.MQ3).accepted
    assert q.submit(m.MQ1).reason == "queue_full"
    q2 = m.RequestQueue(max_depth=2, admission_weight=lambda rpq: 0.0)
    assert q2.submit(m.MQ1).accepted and q2.submit(m.MQ3).accepted
    rej = q2.submit(m.MQ3)
    assert rej.reason == "queue_full" and q2.rejected_cold == 0
    return rej.retry_after_s


def test_admission_classes_inactive_without_weight_hook_or_signal():
    _both(_inactive)


def _grades(m):
    loop = m.ServingLoop(m.musicbrainz_like(400, seed=3), 4,
                         config=m.ServeLoopConfig(micro_batch=8, max_queue_depth=8))
    for _ in range(6):
        for q in [m.MQ1] * 7 + [m.MQ3]:
            loop.submit(q)
        loop.pump()
    assert loop._adm_freqs[m.MQ1.qhash] > loop._adm_freqs.get(m.MQ3.qhash, 0.0)
    while loop.requests.depth() < loop.cfg.max_queue_depth - 1:
        assert loop.submit(m.MQ1).accepted
    cold, hot = loop.submit(m.MQ3), loop.submit(m.MQ1)
    assert not cold.accepted and cold.reason == "cold_backpressure" and hot.accepted
    stats = loop.stop()
    assert stats["rejected_cold_requests"] >= 1
    return (stats["rejected_cold_requests"], stats["completed"], stats["invocations"],
            sorted(loop._adm_freqs.values()), loop.part.tolist())


def test_serving_loop_grades_backpressure_by_sketch_frequency():
    _both(_grades)


def _fifo(m):
    q = m.RequestQueue(max_depth=16)
    t1, t2, t3 = q.submit(m.MQ1), q.submit(m.MQ3), q.submit(m.MQ1)
    assert q.take_batch(2) == [t1, t2] and q.take_batch(2) == [t3]
    return q.take_batch(2, timeout=0)


def test_request_queue_micro_batch_is_fifo():
    assert _both(_fifo) == []


def _retry_monotone(m):
    freqs = {m.MQ1.qhash: 0.9, m.MQ3.qhash: 0.02}
    q = m.RequestQueue(max_depth=16, hot_reserve_frac=0.75,
                       admission_weight=lambda rpq: freqs[rpq.qhash])
    for _ in range(4):
        assert q.submit(m.MQ1).accepted
    hints = []
    while q.depth() < q.max_depth:
        rej = q.submit(m.MQ3)
        assert rej.reason == "cold_backpressure"
        hints.append(rej.retry_after_s)
        assert q.submit(m.MQ1).accepted
    assert all(b >= a for a, b in zip(hints, hints[1:])) and hints[-1] > hints[0]
    shallow, deep = m.IngestQueue(max_depth=4), m.IngestQueue(max_depth=32)
    for iq in (shallow, deep):
        while iq.submit(m.MutationBatch(add_edges=[(0, 1)])) is True:
            pass
    d = deep.submit(m.MutationBatch(add_edges=[(0, 1)])).retry_after_s
    s = shallow.submit(m.MutationBatch(add_edges=[(0, 1)])).retry_after_s
    assert d > s
    return hints, d, s


def test_retry_hints_monotone_in_backlog_depth():
    _both(_retry_monotone)


def _hot_never_later(m):
    freqs = {m.MQ1.qhash: 0.8, m.MQ3.qhash: 0.05}
    q = m.RequestQueue(max_depth=8, admission_weight=lambda rpq: freqs[rpq.qhash])
    while q.depth() < q.max_depth:
        assert q.submit(m.MQ1).accepted
    out = []
    for round_service_s in (1e-3, 5e-3, 2e-2, 1e-1):
        q.record_service_time(round_service_s)
        hot, cold = q.submit(m.MQ1), q.submit(m.MQ3)
        assert not hot.accepted and not cold.accepted
        assert hot.retry_after_s <= cold.retry_after_s
        out.append((hot.retry_after_s, cold.retry_after_s))
    assert q.rejected == 8
    return out


def test_hot_hint_never_later_than_cold_under_sustained_overload():
    _both(_hot_never_later)


# ---------------------------------------------------------------------------
# ingest queue and coalescing
# ---------------------------------------------------------------------------


def _ingest_backpressure(m):
    iq = m.IngestQueue(max_depth=2)
    assert iq.submit(m.MutationBatch(add_edges=[(0, 1)])) is True
    assert iq.submit(m.MutationBatch(add_edges=[(1, 2)])) is True
    rej = iq.submit(m.MutationBatch(add_edges=[(2, 3)]))
    assert not rej.accepted and rej.reason == "ingest_full" and iq.rejected == 1
    return rej.retry_after_s


def test_ingest_queue_backpressure():
    _both(_ingest_backpressure)


def _arrays(g):
    return (g.n, g.version, g.labels.tolist(), g.src.tolist(), g.dst.tolist(),
            g.row_ptr.tolist())


def _batch_fields(b):
    return tuple(np.asarray(x).tolist() for x in (
        b.add_vertex_labels, b.add_edges, b.remove_edges, b.remove_vertices, b.relabel))


def _coalesce(m, make, n_merged):
    """Apply ``make(m)``'s batches one by one and coalesced: the two graphs
    must be equal; returns the merged batches and the graph."""
    g1, batches = make(m)
    g2 = g1.copy()
    merged = m.coalesce_mutations(batches)
    assert n_merged is None or len(merged) == n_merged
    for b in batches:
        g1.apply_mutations(b)
    for b in merged:
        g2.apply_mutations(b)
    assert _arrays(g1)[:1] + _arrays(g1)[2:] == _arrays(g2)[:1] + _arrays(g2)[2:]
    return [_batch_fields(b) for b in merged], _arrays(g1)


def test_coalesce_order_add_then_remove_is_absent():
    def make(m):
        return (m.power_law_labelled(60, n_labels=3, avg_degree=4.0, seed=1),
                [m.MutationBatch(add_edges=[(0, 9)]), m.MutationBatch(remove_edges=[(0, 9)])])
    _, (n, _, _, src, dst, row_ptr) = _both(_coalesce, make, 1)
    assert 9 not in dst[row_ptr[0]:row_ptr[1]]


def test_coalesce_order_remove_then_add_is_present():
    def make(m):
        g = m.power_law_labelled(60, n_labels=3, avg_degree=4.0, seed=2)
        u, w = int(g.src[0]), int(g.dst[0])
        return g, [m.MutationBatch(remove_edges=[(u, w)]),
                   m.MutationBatch(add_edges=[(u, w)])]
    _both(_coalesce, make, 1)


def test_coalesce_splits_on_add_after_vertex_removal():
    def make(m):
        return (m.power_law_labelled(60, n_labels=3, avg_degree=4.0, seed=3),
                [m.MutationBatch(remove_vertices=[5]), m.MutationBatch(add_edges=[(5, 11)])])
    _, (_, _, _, _, dst, row_ptr) = _both(_coalesce, make, 2)
    assert 11 in dst[row_ptr[5]:row_ptr[6]]


def test_coalesce_relabel_last_wins_and_new_vertices_align():
    def make(m):
        return (m.power_law_labelled(60, n_labels=4, avg_degree=4.0, seed=4),
                [m.MutationBatch(add_vertex_labels=[1], add_edges=[(60, 2)], relabel=[(7, 0)]),
                 m.MutationBatch(add_vertex_labels=[2], add_edges=[(61, 60)],
                                 relabel=[(7, 3), (60, 0)])])
    _, (_, _, labels, _, _, _) = _both(_coalesce, make, 1)
    assert labels[7] == 3 and labels[60] == 0


@pytest.mark.parametrize("seed", range(4))
def test_coalesce_random_stream_parity(seed):
    def make(m):
        rng = np.random.default_rng(seed)
        g = m.power_law_labelled(80, n_labels=4, avg_degree=5.0, seed=seed)
        batches, n_virtual = [], g.n
        for _ in range(6):
            nv = int(rng.integers(0, 3))
            hi = n_virtual + nv
            batches.append(m.MutationBatch(
                add_vertex_labels=rng.integers(0, 4, nv),
                add_edges=np.stack([rng.integers(0, hi, 6), rng.integers(0, hi, 6)], 1),
                remove_edges=np.stack([rng.integers(0, n_virtual, 4),
                                       rng.integers(0, n_virtual, 4)], 1),
                remove_vertices=([int(rng.integers(0, n_virtual))]
                                 if rng.random() < 0.4 else []),
                relabel=([(int(rng.integers(0, n_virtual)), int(rng.integers(0, 4)))]
                         if rng.random() < 0.5 else [])))
            n_virtual = hi
        return g, batches
    # the port's coalescer folds the stream into the reference's batches
    _both(_coalesce, make, None)


# ---------------------------------------------------------------------------
# Breaker
# ---------------------------------------------------------------------------


def test_breaker_trips_on_error_rate_not_just_streak():
    def s(m):
        b = m.Breaker("x", window=8, min_failures=2, error_rate=0.5)
        out = [b.record_failure()]
        b.record_success()
        out += [b.record_failure(), b.state, b.trips, b.record_failure()]
        return out
    assert _both(s) == [False, True, "open", 1, False]


def test_breaker_consecutive_tail_trips_below_rate():
    def s(m):
        b = m.Breaker("x", window=16, min_failures=3, error_rate=0.9)
        for _ in range(10):
            b.record_success()
        b.record_failure()
        b.record_failure()
        return [b.state, b.record_failure(), b.state]
    assert _both(s) == ["closed", True, "open"]


def test_breaker_no_trip_below_min_failures():
    def s(m):
        b = m.Breaker("x", window=8, min_failures=3, error_rate=0.1)
        b.record_failure()
        b.record_failure()
        return b.state
    assert _both(s) == "closed"


def test_breaker_cooldown_halfopen_probe_and_close():
    def s(m):
        clk, rec = FakeClock(), ListRecorder()
        b = m.Breaker("dep", window=4, min_failures=2, error_rate=0.5,
                      cooldown_s=1.0, recorder=rec, clock=clk)
        b.record_failure()
        b.record_failure()
        out = [b.state, b.allow(), b.allow(), b.fast_failures]
        clk.advance(1.01)
        out += [b.allow(), b.state]
        b.record_success()
        out += [b.state, b.closes, b.record_failure()]
        return out, [(e["frm"], e["to"]) for e in rec.of("breaker_transition")]
    out, frames = _both(s)
    assert out == ["open", False, False, 2, True, "half_open", "closed", 1, False]
    assert frames == [("closed", "open"), ("open", "half_open"), ("half_open", "closed")]


def test_breaker_failed_probe_doubles_cooldown_up_to_max():
    def s(m):
        clk = FakeClock()
        b = m.Breaker("dep", window=4, min_failures=1, error_rate=1.0,
                      cooldown_s=1.0, cooldown_max_s=3.0, clock=clk)
        b.record_failure()
        cooldowns = []
        for _ in range(3):
            clk.advance(b._cooldown_s + 0.01)
            assert b.allow() and b.state == "half_open"
            b.record_failure()
            assert b.state == "open"
            cooldowns.append(b._cooldown_s)
        clk.advance(b._cooldown_s + 0.01)
        assert b.allow()
        b.record_success()
        return cooldowns, b.state, b._cooldown_s
    assert _both(s) == ([2.0, 3.0, 3.0], "closed", 1.0)


def test_breaker_open_ignores_straggler_success():
    def s(m):
        b = m.Breaker("x", window=4, min_failures=1, error_rate=1.0, cooldown_s=99.0,
                      clock=FakeClock())
        b.record_failure()
        b.record_success()
        return b.state
    assert _both(s) == "open"


def test_breaker_reset_reopens_fresh():
    def s(m):
        b = m.Breaker("x", window=4, min_failures=1, error_rate=1.0)
        b.record_failure()
        out = [b.state]
        b.reset()
        return out + [b.state, b.allow()]
    assert _both(s) == ["open", "closed", True]


# ---------------------------------------------------------------------------
# WindowedQuantile, serve_pressure
# ---------------------------------------------------------------------------


def test_windowed_quantile_sees_only_the_window():
    def s(m):
        h = m.Registry().histogram("lat", cls="hot")
        for _ in range(100):
            h.observe(0.001)
        w = m.WindowedQuantile(h)
        w.advance()
        for _ in range(10):
            h.observe(0.9)
        assert w.count == 10 and h.quantile(0.5) < 0.01 and w.quantile(0.5) > 0.1
        return w.count, h.quantile(0.5), w.quantile(0.5)
    _both(s)


def test_windowed_quantile_empty_window_is_none():
    def s(m):
        h = m.Registry().histogram("lat", cls="hot")
        h.observe(0.5)
        w = m.WindowedQuantile(h)
        w.advance()
        return w.count, w.quantile(0.99)
    assert _both(s) == (0, None)


def test_windowed_quantile_interpolates_within_bucket():
    def s(m):
        h = m.Registry().histogram("lat", cls="hot")
        w = m.WindowedQuantile(h)
        for _ in range(8):
            h.observe(0.3)
        q = w.quantile(0.5)
        assert max(b for b in h.bounds if b < 0.3) <= q <= min(b for b in h.bounds if b >= 0.3)
        return q
    _both(s)


def test_serve_pressure_weights_and_clamp():
    def s(m):
        cfg = m.ControlConfig()
        p = m.serve_pressure(0.5, 0.0, 0.0, cfg)
        assert p == pytest.approx(cfg.pressure_depth_weight * 0.5)
        mixed = m.serve_pressure(-1.0, 0.2, 0.1, cfg)
        assert 0.0 <= mixed <= 1.0
        return (m.serve_pressure(0.0, 0.0, 0.0, cfg), m.serve_pressure(9.0, 9.0, 9.0, cfg),
                p, mixed)
    assert _both(s)[:2] == (0.0, 1.0)


# ---------------------------------------------------------------------------
# RequestQueue brownout shedding
# ---------------------------------------------------------------------------


def test_queue_shed_level_rejects_cold_keeps_hot():
    def s(m):
        q = m.RequestQueue(max_depth=16)
        q.max_shed_level, q.shed_classes = 4, ("cold",)
        q.set_shed_level(4)
        r = q.submit(m.MQ1, cls="cold")
        assert isinstance(r, m.Rejection) and r.reason == "brownout"
        return q.rejected_brownout, isinstance(q.submit(m.MQ1, cls="hot"), m.Rejection)
    assert _both(s) == (1, False)


def test_queue_partial_shed_shrinks_admission_zone():
    def s(m):
        q = m.RequestQueue(max_depth=8)
        q.max_shed_level, q.shed_classes = 4, ("cold",)
        q.set_shed_level(2)
        admitted = sum(not isinstance(q.submit(m.MQ1, cls="cold"), m.Rejection)
                       for _ in range(8))
        q2 = m.RequestQueue(max_depth=8)
        q2.set_shed_level(q2.max_shed_level)
        rej = q2.submit(m.MQ1, cls="cold")
        base = m.RequestQueue(max_depth=1)
        base.submit(m.MQ1, cls="hot")
        full = base.submit(m.MQ1, cls="hot")
        assert rej.retry_after_s > full.retry_after_s
        return admitted, rej.retry_after_s, full.retry_after_s
    assert 0 < _both(s)[0] < 8


def test_queue_set_shed_level_clamps():
    def s(m):
        q = m.RequestQueue(max_depth=8)
        q.max_shed_level = 3
        q.set_shed_level(99)
        high = q.shed_level
        q.set_shed_level(-4)
        return high, q.shed_level
    assert _both(s) == (3, 0)


# ---------------------------------------------------------------------------
# BrownoutController
# ---------------------------------------------------------------------------


def _brownout(m, clk, **over):
    kw = dict(slo_budget_s={"hot": 0.05}, window_s=1.0, min_window_samples=4,
              shed_levels=3, clear_ratio=0.5, clear_windows=2, clock=clk)
    kw.update(over)
    reg, q, rec = m.Registry(), m.RequestQueue(max_depth=32), ListRecorder()
    return m.BrownoutController(q, reg, m.ControlConfig(**kw), recorder=rec), reg, q, rec


def _feed(reg, value, n=8, cls="hot"):
    h = reg.histogram("request_latency_s", cls=cls)
    for _ in range(n):
        h.observe(value)


def test_brownout_breach_raises_one_level_per_window():
    def s(m):
        bo, reg, q, rec = _brownout(m, FakeClock())
        ticks = []
        for _ in range(4):
            _feed(reg, 0.4)
            ticks.append(bo.tick())
        return ticks, q.shed_level, bo.shed_raises, rec.of("shed_level")
    ticks, level, raises, evs = _both(s)
    assert ticks == [1, 2, 3, None] and level == 3 and raises == 3
    assert [e["level"] for e in evs] == [1, 2, 3] and all(e["raised"] for e in evs)
    assert evs[0]["cls"] == "hot" and evs[0]["budget_s"] == 0.05


def test_brownout_recovery_is_hysteretic():
    def s(m):
        bo, reg, q, _ = _brownout(m, FakeClock())
        _feed(reg, 0.4)
        bo.tick()
        out = [q.shed_level]
        _feed(reg, 0.001)
        out += [bo.tick(), q.shed_level]
        _feed(reg, 0.001)
        return out + [bo.tick(), q.shed_level, bo.shed_drops]
    assert _both(s) == [1, None, 1, 0, 0, 1]


def test_brownout_idle_window_is_not_recovery():
    def s(m):
        bo, reg, q, _ = _brownout(m, FakeClock())
        _feed(reg, 0.4)
        bo.tick()
        return [bo.tick() for _ in range(5)], q.shed_level
    assert _both(s) == ([None] * 5, 1)


def test_brownout_near_budget_resets_clear_streak():
    def s(m):
        bo, reg, q, _ = _brownout(m, FakeClock())
        out = []
        for v in (0.4, 0.001, 0.04, 0.001):
            _feed(reg, v)
            out.append(bo.tick())
        return out, q.shed_level
    assert _both(s) == ([1, None, None, None], 1)


def test_brownout_maybe_tick_respects_window_cadence():
    def s(m):
        clk = FakeClock()
        bo, reg, q, _ = _brownout(m, clk)
        _feed(reg, 0.4)
        out = [bo.maybe_tick(), bo.ticks]
        clk.advance(1.01)
        return out + [bo.maybe_tick(), bo.ticks]
    assert _both(s) == [None, 0, 1, 1]


def test_brownout_set_budget_live():
    def s(m):
        bo, reg, q, _ = _brownout(m, FakeClock())
        _feed(reg, 0.01)
        out = [bo.tick()]
        bo.set_budget("hot", 1e-6)
        _feed(reg, 0.01)
        return out + [bo.tick()]
    assert _both(s) == [None, 1]


# ---------------------------------------------------------------------------
# HedgeController
# ---------------------------------------------------------------------------


def test_hedge_deadline_defaults_to_budget_without_estimate():
    def s(m):
        cfg = m.ControlConfig(window_s=1.0, min_window_samples=4, clock=FakeClock())
        hc = m.HedgeController(m.Registry(), cfg)
        return hc.deadline("hot", 0.05), hc.deadline("hot", None)
    assert _both(s) == (0.05, None)


def test_hedge_deadline_tracks_quantile_clamped_to_budget():
    def s(m):
        clk = FakeClock()
        cfg = m.ControlConfig(window_s=1.0, min_window_samples=4, hedge_factor=1.5,
                              hedge_floor_s=1e-3, clock=clk)
        reg = m.Registry()
        hc = m.HedgeController(reg, cfg)
        hc.deadline("hot", 0.5)
        h = reg.histogram("router_latency_s", cls="hot")
        for _ in range(8):
            h.observe(0.01)
        clk.advance(1.01)
        d = hc.deadline("hot", 0.5)
        assert cfg.hedge_floor_s <= d < 0.5
        for _ in range(8):
            h.observe(30.0)
        clk.advance(1.01)
        return d, hc.deadline("hot", 0.5)
    assert _both(s)[1] == 0.5


def test_hedge_floor_clamp():
    def s(m):
        clk = FakeClock()
        cfg = m.ControlConfig(window_s=1.0, min_window_samples=2, hedge_floor_s=0.25,
                              clock=clk)
        reg = m.Registry()
        hc = m.HedgeController(reg, cfg)
        hc.deadline("hot", 0.5)
        h = reg.histogram("router_latency_s", cls="hot")
        for _ in range(4):
            h.observe(1e-5)
        clk.advance(1.01)
        return hc.deadline("hot", 0.5)
    assert _both(s) == 0.25


# ---------------------------------------------------------------------------
# pressure-aware invocation cadence
# ---------------------------------------------------------------------------


def _dirty_taper(m, policy):
    ot = m.OnlineTaper(m.musicbrainz_like(200, seed=3), 4, policy=policy,
                       config=m.TaperConfig(max_iterations=2))
    for i in range(40):
        ot.apply_mutations(m.MutationBatch(add_edges=[(i % 50, (i * 3) % 50)]))
    return ot


def test_policy_defers_invocation_under_pressure():
    def s(m):
        ot = _dirty_taper(m, m.OnlinePolicy(
            bootstrap_after_ticks=None, cadence=10 ** 9, min_interval=0,
            dirty_fraction=0.01, drift_l1=9e9, ipt_regression=9e9,
            defer_above_pressure=0.5))
        out = [ot.poll(pressure=0.9), ot.pressure_deferrals]
        return out + [ot.poll(pressure=0.1), ot.pressure_deferrals]
    assert _both(s) == [None, 1, "topology", 1]


def test_policy_accelerates_at_idle():
    def s(m):
        ot = m.OnlineTaper(m.musicbrainz_like(200, seed=3), 4, config=m.TaperConfig(max_iterations=2),
                           policy=m.OnlinePolicy(
                               bootstrap_after_ticks=None, cadence=10 ** 9, min_interval=0,
                               dirty_fraction=2.0, drift_l1=9e9, ipt_regression=1.2,
                               accelerate_below_pressure=0.2, accel_factor=0.5))
        ot.poll()
        ot.invoke("seed")
        ot._ipt_at_invoke = 1.0
        return [ot.poll(measured_ipt=1.12, pressure=0.5),
                ot.poll(measured_ipt=1.12, pressure=0.1), ot.part.tolist()]
    out = _both(s)
    assert out[0] is None and out[1] == "ipt"


# ---------------------------------------------------------------------------
# the serving loop: brownout end to end
# ---------------------------------------------------------------------------


def _brownout_loop(m, tmp_path):
    clk = FakeClock()
    ctl = m.ControlConfig(slo_budget_s={"hot": 1e-6}, window_s=0.5, min_window_samples=2,
                          shed_levels=2, clear_windows=1, clock=clk)
    pol = m.OnlinePolicy(bootstrap_after_ticks=0, cadence=10 ** 9, min_interval=0,
                         dirty_fraction=2.0, drift_l1=9e9, ipt_regression=9e9)
    loop = m.ServingLoop(m.musicbrainz_like(300, seed=7), 4,
                         taper_config=m.TaperConfig(max_iterations=2), policy=pol,
                         config=m.ServeLoopConfig(micro_batch=8, overlap_invocations=False,
                                                  snapshot_dir=str(tmp_path), control=ctl))
    levels = []
    try:
        for _ in range(4):
            loop.submit(m.MQ1, cls="hot")
            loop.submit(m.MQ3, cls="cold")
        loop.pump()
        clk.advance(0.51)
        loop.submit(m.MQ1, cls="hot")
        loop.pump()
        st = loop.stats()
        assert 0.0 <= st["serve_pressure"] <= 1.0
        levels.append((st["shed_level"], st["backend_breaker_state"]))
        for _ in range(4):
            loop.submit(m.MQ1, cls="hot")
        loop.pump()
        clk.advance(0.51)
        loop.submit(m.MQ1, cls="hot")
        loop.pump()
        levels.append(loop.stats()["shed_level"])
        rej = sum(isinstance(loop.submit(m.MQ3, cls="cold"), m.Rejection) for _ in range(12))
        assert rej > 0 and loop.stats()["rejected_brownout"] == rej
        loop._brownout.set_budget("hot", 1e9)
        for _ in range(4):
            for _ in range(4):
                loop.submit(m.MQ1, cls="hot")
            loop.pump()
            clk.advance(0.51)
            loop.submit(m.MQ1, cls="hot")
            loop.pump()
            levels.append(loop.stats()["shed_level"])
            if levels[-1] == 0:
                break
    finally:
        loop.stop()
    return levels, rej, loop.part.tolist()


def test_serving_loop_brownout_end_to_end(tmp_path):
    levels, rej, _ = _both(_brownout_loop, tmp_path)
    assert levels[0] == (1, "closed") and levels[1] == 2 and levels[-1] == 0


# ---------------------------------------------------------------------------
# faults (the ladder and shard-upload twins: tests/test_torch_cuda.py)
# ---------------------------------------------------------------------------


def _eager_policy(m):
    return m.OnlinePolicy(bootstrap_after_ticks=0, cadence=1, min_interval=0,
                          dirty_fraction=2.0, drift_l1=9e9, ipt_regression=9e9)


def _quiet_policy(m):
    return m.OnlinePolicy(bootstrap_after_ticks=None, cadence=10 ** 9, min_interval=0,
                          dirty_fraction=2.0, drift_l1=9e9, ipt_regression=9e9)


def _topology_policy(m):
    return m.OnlinePolicy(bootstrap_after_ticks=None, cadence=10 ** 9, min_interval=0,
                          dirty_fraction=1e-9, drift_l1=9e9, ipt_regression=9e9)


def test_fault_injector_arm_fire_exhaust_disarm():
    def s(m):
        fi = m.FaultInjector()
        fi.fire("invocation")
        fi.arm("invocation", times=2)
        for _ in range(2):
            with pytest.raises(m.InjectedFault):
                fi.fire("invocation")
        fi.fire("invocation")
        out = [fi.fired_total()]
        fi.arm("shard_upload", times=-1)
        for _ in range(3):
            with pytest.raises(m.InjectedFault):
                fi.fire("shard_upload")
        fi.disarm("shard_upload")
        fi.fire("shard_upload")
        with pytest.raises(ValueError):
            m.FaultSpec(mode="explode")
        return out + [fi.fired_total()]
    assert _both(s) == [2, 5]


def test_fault_injector_rejects_unknown_site():
    def s(m):
        fi = m.FaultInjector()
        msgs = []
        for bad in ("invocatoin", "not_a_site:replica-1"):
            with pytest.raises(ValueError) as err:
                fi.arm(bad)
            msgs.append(str(err.value))
        fi.arm("replica_serve:replica-1")
        return msgs, fi.armed("replica_serve:replica-1")
    msgs, armed = _both(s)
    assert "unknown fault site 'invocatoin'" in msgs[0] and "valid sites: " in msgs[1]
    assert armed


def test_fault_injector_stall_mode_sleeps_not_raises():
    fi = p_faults.FaultInjector()
    fi.arm("invocation", mode="stall", delay_s=0.05)
    t0 = time.perf_counter()
    fi.fire("invocation")
    assert time.perf_counter() - t0 >= 0.04 and fi.fired_total() == 1


def _retry_backoff(m):
    g = m.musicbrainz_like(300, seed=22)
    fi = m.FaultInjector()
    loop = m.ServingLoop(g, 4, taper_config=m.TaperConfig(max_iterations=2),
                         policy=_eager_policy(m),
                         config=m.ServeLoopConfig(micro_batch=4, overlap_invocations=False,
                                                  faults=fi, invocation_retry_backoff_s=30.0,
                                                  backend_fallback_after=99))
    fi.arm(m.SITE_INVOCATION, times=1)
    loop.submit(m.MQ1)
    with pytest.raises(m.InjectedFault):
        loop.pump()
    assert loop._backoff_until > time.monotonic() + 10
    inv = loop.ot.invocations
    loop.submit(m.MQ1)
    assert loop.pump() == 1 and loop.ot.invocations == inv
    loop._backoff_until = 0.0
    loop.submit(m.MQ1)
    loop.pump()
    assert loop.ot.invocations == inv + 1
    s = loop.stats()
    return inv, s["invocation_failures"], s["field_backend"], loop.part.tolist()


def test_invocation_failure_sets_retry_backoff():
    inv, failures, backend, _ = _both_backend(_retry_backoff)
    assert failures == 1 and backend == "torch"


def _wait(cond, what, timeout=30.0):
    t_end = time.perf_counter() + timeout
    while not cond():
        assert time.perf_counter() < t_end, f"{what} within {timeout} s"
        time.sleep(0.01)


def test_watchdog_aborts_stalled_invocation_and_gates_ingest():
    m = PORT
    g = m.musicbrainz_like(300, seed=23)
    fi = m.FaultInjector()
    loop = m.ServingLoop(g, 4, taper_config=m.TaperConfig(max_iterations=2),
                         policy=_eager_policy(m),
                         config=m.ServeLoopConfig(micro_batch=4, overlap_invocations=True,
                                                  faults=fi, invocation_timeout_s=0.05,
                                                  invocation_retry_backoff_s=0.0))
    fi.arm(m.SITE_INVOCATION, mode="stall", delay_s=0.6)
    loop.submit(m.MQ1)
    loop.pump()
    assert loop.invocation_in_flight
    t0 = time.perf_counter()
    while loop.invocation_in_flight:          # the watchdog's 50 ms budget
        assert time.perf_counter() - t0 < 5.0
        time.sleep(0.06)
        loop.pump()
    s = loop.stats()
    assert s["watchdog_aborts"] == 1 and "TimeoutError" in s["invocation_error"]
    assert s["healthy"] == 0 and loop._zombies_active()
    v0, n0 = g.version, g.n
    assert loop.submit_mutations(m.MutationBatch(add_vertex_labels=[0],
                                                 add_edges=[(0, n0)])) is True
    loop.submit(m.MQ1)
    assert loop.pump() == 1 and g.version == v0
    _wait(lambda: not loop._zombies_active(), "the zombie's exit")
    loop.pump()
    assert g.version == v0 + 1
    inv = loop.ot.invocations
    t_end = time.perf_counter() + 30.0
    while loop.ot.invocations == inv:
        assert time.perf_counter() < t_end
        loop.submit(m.MQ1)
        loop.pump()
        loop._finish_inflight()
    assert loop.stats()["invocation_error"] == ""
    loop.stop()


def test_failed_invocation_leaves_dirty_bits_for_retry():
    m = PORT
    g = m.musicbrainz_like(300, seed=24)
    fi = m.FaultInjector()
    loop = m.ServingLoop(g, 4, taper_config=m.TaperConfig(max_iterations=2),
                         policy=_topology_policy(m),
                         config=m.ServeLoopConfig(micro_batch=4, overlap_invocations=True,
                                                  faults=fi, invocation_retry_backoff_s=0.0))
    loop.submit(m.MQ1)
    loop.pump()
    assert loop.submit_mutations(m.MutationBatch(add_vertex_labels=[0],
                                                 add_edges=[(0, g.n)])) is True
    fi.arm(m.SITE_INVOCATION, times=1)
    loop.submit(m.MQ1)
    loop.pump()
    dirty_before = int(loop.ot._dirty.sum())
    assert dirty_before > 0
    assert loop._invocation_done.wait(5.0)
    loop.pump()
    s = loop.stats()
    assert "InjectedFault" in s["invocation_error"] and s["healthy"] == 0
    assert int(loop.ot._dirty.sum()) == dirty_before
    inv = loop.ot.invocations
    t_end = time.perf_counter() + 30.0
    while loop.ot.invocations == inv:
        assert time.perf_counter() < t_end
        loop.submit(m.MQ1)
        loop.pump()
        loop._finish_inflight()
    assert int(loop.ot._dirty.sum()) == 0
    assert loop.stats()["invocation_error"] == ""
    loop.stop()


def _poisoned(m, tmp_path):
    g = m.musicbrainz_like(300, seed=25)
    fi = m.FaultInjector()
    loop = m.ServingLoop(g, 4, taper_config=m.TaperConfig(max_iterations=2),
                         policy=_quiet_policy(m),
                         config=m.ServeLoopConfig(micro_batch=4, overlap_invocations=False,
                                                  faults=fi, snapshot_dir=str(tmp_path)))
    loop.snapshot(sync=True)
    v0, n0 = g.version, g.n
    fi.arm(m.SITE_INGEST_GROUP, times=1)
    for i in range(3):
        assert loop.submit_mutations(m.MutationBatch(add_vertex_labels=[i],
                                                     add_edges=[(i, n0 + i)])) is True
    loop.pump()
    assert g.version == v0 + 3 and loop.ingest.failed == 0 and fi.fired_total() == 1
    assert loop.stats()["failed_mutations"] == 0
    restored = m.restore(tmp_path, taper_config=m.TaperConfig(max_iterations=2),
                         policy=_quiet_policy(m),
                         config=m.ServeLoopConfig(micro_batch=4, overlap_invocations=False))
    assert restored.restore_result.replayed == 3
    assert restored.g.version == g.version and restored.g.n == g.n
    assert np.array_equal(restored.g.src, g.src)
    assert np.array_equal(restored.ot._dirty, loop.ot._dirty)
    assert [r.version for r in restored.g.mutation_log] == [r.version for r in g.mutation_log]
    loop.stop()
    restored.stop(drain=False)
    return _arrays(g), loop.part.tolist(), restored.part.tolist()


def test_poisoned_ingest_group_falls_back_to_member_batches(tmp_path):
    _both(lambda m: _poisoned(m, tmp_path / ("port" if m is PORT else "ref")))


@pytest.mark.parametrize("site", ["SITE_INVOCATION", "SITE_SHARD_UPLOAD", "SITE_INGEST_GROUP"])
def test_loop_fault_sites_are_the_reference_sites(site):
    assert getattr(p_faults, site) == getattr(r_faults, site)


# ---------------------------------------------------------------------------
# a failed kernel is no ladder strike; stop() has a deadline (port only)
# ---------------------------------------------------------------------------


def _kernel_fault_loop(fi, overlap, **cfg):
    m = PORT
    return m.ServingLoop(
        m.musicbrainz_like(300, seed=26), 4,
        taper_config=m.TaperConfig(max_iterations=2, field_backend="cuda"),
        policy=_eager_policy(m),
        config=m.ServeLoopConfig(micro_batch=4, overlap_invocations=overlap, faults=fi,
                                 invocation_retry_backoff_s=0.0,
                                 backend_fallback_after=1, **cfg))


def _pump_until_raises(loop, exc, mq):
    """Pump (submitting a request a round) until ``exc`` comes out."""
    t_end = time.perf_counter() + 30.0
    while True:
        assert time.perf_counter() < t_end, f"no {exc.__name__} within 30 s"
        loop.submit(mq)
        try:
            loop.pump(wait_s=0.01)
        except exc:
            return


@pytest.mark.parametrize("overlap", [False, True])
def test_kernel_error_is_no_ladder_strike(overlap):
    """A kernel that fails to build or launch keeps the loop on its rung:
    no fallback, no retry; serving goes on, pump() and stop() raise it.
    (The field never runs here: the fault fires before it.)"""
    fi = p_faults.FaultInjector()
    loop = _kernel_fault_loop(fi, overlap)
    fi.arm(p_faults.SITE_INVOCATION, times=-1, exc=KernelError)
    _pump_until_raises(loop, KernelError, PORT.MQ1)
    s = loop.stats()
    assert s["field_backend"] == "cuda" and s["backend_fallbacks"] == 0
    assert s["invocation_failures"] == 1 and "KernelError" in s["invocation_error"]
    assert fi.fired_total() == 1 and loop.ot.invocations == 0
    served = loop.metrics.completed
    ticket = loop.submit(PORT.MQ1)
    with pytest.raises(KernelError):
        loop.pump()
    assert ticket.done.is_set() and loop.metrics.completed == served + 1
    assert fi.fired_total() == 1 and not loop.invocation_in_flight
    with pytest.raises(KernelError):
        loop.stop()


def test_kernel_error_reaps_the_failed_overlapped_run(monkeypatch):
    """The failed run publishes its error, then logs, then sets its done
    flag: ``pump()`` raises only after reaping it, however slow the log."""
    import repro_torch.serve.loop as loop_mod

    log_exception = loop_mod.log.exception
    monkeypatch.setattr(loop_mod.log, "exception",
                        lambda *a, **kw: (time.sleep(0.3), log_exception(*a, **kw)))
    fi = p_faults.FaultInjector()
    loop = _kernel_fault_loop(fi, True)
    fi.arm(p_faults.SITE_INVOCATION, times=-1, exc=KernelError)
    _pump_until_raises(loop, KernelError, PORT.MQ1)
    assert not loop.invocation_in_flight and fi.fired_total() == 1
    with pytest.raises(KernelError):
        loop.stop()


def test_injected_fault_walks_the_ladder_where_a_kernel_error_does_not():
    """The same loop under an injected (non-kernel) fault demotes at once."""
    fi = p_faults.FaultInjector()
    loop = _kernel_fault_loop(fi, False)
    fi.arm(p_faults.SITE_INVOCATION, times=1)
    _pump_until_raises(loop, p_faults.InjectedFault, PORT.MQ1)
    s = loop.stats()
    assert s["field_backend"] == "torch" and s["backend_fallbacks"] == 1
    loop.stop()


def test_stop_deadline_aborts_the_run_and_raises():
    """stop() waits at most stop_timeout_s for an in-flight run, tells it to
    abort and raises; the run then exits at its next check."""
    m = PORT
    loop = m.ServingLoop(m.musicbrainz_like(300, seed=27), 4,
                         taper_config=m.TaperConfig(max_iterations=2),
                         policy=_eager_policy(m),
                         config=m.ServeLoopConfig(micro_batch=4, overlap_invocations=True,
                                                  stop_timeout_s=0.2))
    release, run = threading.Event(), loop.ot.run_invocation

    def gated(pending, should_abort=None):
        assert release.wait(30.0)
        return run(pending, should_abort=should_abort)

    loop.ot.run_invocation = gated
    loop.submit(m.MQ1)
    loop.pump()
    assert loop.invocation_in_flight
    inflight = loop._inflight
    with pytest.raises(TimeoutError, match="the invocation still running"):
        loop.stop()
    assert loop._abort_flag.is_set()
    release.set()
    inflight.join(30.0)
    assert not inflight.is_alive() and loop.ot.invocations == 0


def test_kernel_build_failure_is_a_kernel_error(monkeypatch, tmp_path):
    from repro_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    with pytest.raises(KernelError, match="nvcc"):
        build.build_all()
