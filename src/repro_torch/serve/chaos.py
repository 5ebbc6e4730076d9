"""Deterministic chaos-soak harness for the serving cluster.

Each failure mode is tested in isolation elsewhere — one injected fault,
one crash, one partition per test.  This module composes those same fault
sites (``serve.faults.FaultInjector``, ``ShipChannel`` transport faults,
replica crashes, primary partitions) into *seeded, time-compressed
scenarios* and checks the robustness invariants after every event, so the
control loops are proven under compound storms, not unit faults.

A :class:`Scenario` is a schedule: ``steps`` rounds of seeded load
(router reads, loop-submitted classed requests, topology mutations — all
drawn from one ``numpy`` generator seeded by ``Scenario.seed``) with
:class:`ChaosEvent` actions pinned to step indices (arm/disarm a fault
site, crash/rejoin a follower, partition or crash the primary, force the
heartbeat-lapse failover, rewrite an SLO budget, advance the virtual
clock).  :class:`ChaosHarness` executes it against a real
``ClusterCoordinator`` and returns a :class:`ChaosReport`.

**Determinism.**  Every control decision in a scenario runs on the
harness's :class:`VirtualClock` (``ControlConfig.clock``): breaker
cooldowns and brownout controller windows advance only when the schedule
says so, never with the wall.  Workload, mutations and event order are
seed-fixed; the policy's wall-coupled triggers (workload drift, ipt
regression) are disabled so invocation timing is a pure function of the
tick/mutation stream; and where a decision would depend on a measured
latency *value* (brownout breach), scenarios manipulate the budget
instead (``set_budget`` to ``1e-6`` / ``1e9``) so the comparison outcome
is value-independent.  The report's digest therefore covers exactly the
state that must be bit-reproducible — graph arrays, partition vector,
dirty mask, RNG state, invocation/seq/epoch counters, and a quiesced
probe batch's answers — and running the same scenario twice must produce
identical digests.

**Invariants** (checked at quiesce, after healing everything):

* *no acked commit lost* — the highest journaled seq ever observed on a
  healthy primary survives every crash/partition/failover;
* *staleness bounds honoured* — a spy on the router's serve path records
  any follower read whose version lag exceeded its class bound;
* *bitwise parity* — every live follower's replicated state (graph
  arrays, partition, dirty mask, RNG, invocation count) equals the
  primary's, and a probe batch answers identically on every replica;
* *evidence* — every fired fault site, every promotion/rejoin, every
  breaker transition and shed-level change left its event in the flight
  recorder (the black box tells the whole story).

Device: the harness builds its primary ``ServingLoop`` on ``device``
(default ``"cuda"``; tests pass ``"cpu"``) and the cluster puts every
follower there too.  The field's ``cuda`` rung equals its plain ``torch``
rung bit for bit, so a scenario's digest does not depend on the device.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.online import OnlinePolicy
from repro_torch.core.rpq import parse_rpq
from repro_torch.core.taper import TaperConfig
from repro_torch.device import DeviceLike
from repro_torch.graphs.generators import musicbrainz_like
from repro_torch.graphs.graph import MutationBatch
from repro_torch.obs import Observability
from repro_torch.serve.cluster import ClusterConfig, ClusterCoordinator
from repro_torch.serve.control import ControlConfig
from repro_torch.serve.faults import FaultInjector
from repro_torch.serve.loop import ServeLoopConfig, ServingLoop
from repro_torch.utils import get_logger

log = get_logger("serve.chaos")

__all__ = ["ChaosEvent", "ChaosHarness", "ChaosReport", "Scenario",
           "SCENARIOS", "VirtualClock", "scenario"]

#: the probe workload every scenario serves and digests
PROBE_QUERIES = (parse_rpq("Area.Artist.(Artist|Label).Area"),
                 parse_rpq("Artist.Credit.Track.Medium"))


class VirtualClock:
    """Injectable monotonic clock: time moves only when the scenario says
    so, which is what makes breaker cooldowns and controller windows
    schedule-deterministic instead of wall-deterministic."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


@dataclass
class ChaosEvent:
    """One scheduled action.  ``step`` indexes the scenario round the
    action fires *before*; ``action`` is one of the harness verbs
    (``arm``, ``disarm``, ``crash_follower``, ``rejoin_follower``,
    ``crash_primary``, ``partition_primary``, ``heal_partition``,
    ``force_failover``, ``rejoin_demoted``, ``set_budget``,
    ``advance_clock``, ``set_load``)."""

    step: int
    action: str
    kwargs: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Scenario:
    """A seeded, time-compressed fault storm (module doc)."""

    name: str
    seed: int = 0
    steps: int = 30
    events: List[ChaosEvent] = field(default_factory=list)
    n_followers: int = 2
    #: router reads per step (classed "hot"; the staleness spy watches)
    reads_per_step: int = 1
    #: requests submitted straight into the primary loop's queue per step
    #: (hot, cold) — the flash-crowd/brownout path
    loop_hot_per_step: int = 0
    loop_cold_per_step: int = 0
    #: probability a step also submits a topology mutation
    mutate_prob: float = 0.4
    #: built cluster size / graph seed
    n_vertices: int = 300
    graph_seed: int = 7
    #: control-loop knobs every scenario shares (clock injected at build)
    control: Optional[ControlConfig] = None
    #: extra ClusterConfig overrides
    cluster_kwargs: Dict[str, Any] = field(default_factory=dict)
    #: extra OnlinePolicy overrides (on top of the quiet deterministic
    #: policy — drift/ipt triggers at 9e9)
    policy_kwargs: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ChaosReport:
    """Outcome of one scenario run."""

    scenario: str
    seed: int
    digest: str
    watermark_seq: int
    final_seq: int
    failovers: int
    rejoins: int
    epoch: int
    shed_raises: int
    breaker_trips: int
    faults_fired: Dict[str, int]
    staleness_violations: List[str]
    invariant_errors: List[str]
    stats: Dict[str, Any]

    @property
    def ok(self) -> bool:
        return not self.invariant_errors and not self.staleness_violations


class ChaosHarness:
    """Builds one observed, control-looped cluster and runs a scenario
    against it (module doc)."""

    def __init__(self, directory, sc: Scenario, device: DeviceLike = None):
        self.sc = sc
        self.clock = VirtualClock()
        self.faults = FaultInjector()
        self.obs = Observability(trace_sample_rate=0.0,
                                 dump_dir=str(directory))
        ctl = sc.control or ControlConfig()
        #: the scenario's control config with the virtual clock injected —
        #: chaos runs must never let a breaker or controller read the wall
        from dataclasses import replace as dc_replace
        self.control = dc_replace(ctl, clock=self.clock)
        g = musicbrainz_like(sc.n_vertices, seed=sc.graph_seed)
        loop_cfg = ServeLoopConfig(
            micro_batch=8, overlap_invocations=False,
            snapshot_dir=str(directory), faults=self.faults, obs=self.obs,
            control=self.control)
        primary = ServingLoop(
            g, 4, taper_config=TaperConfig(max_iterations=2),
            policy=self._policy(), config=loop_cfg, device=device)
        ck = dict(heartbeat_timeout_s=9e9, faults=self.faults, obs=self.obs,
                  control=self.control, n_followers=sc.n_followers)
        ck.update(sc.cluster_kwargs)
        self.coord = ClusterCoordinator(
            primary, config=ClusterConfig(**ck), policy=self._policy(),
            taper_config=TaperConfig(max_iterations=2))
        self.rng = np.random.default_rng(sc.seed)
        self.watermark_seq = 0
        self.staleness_violations: List[str] = []
        self.invariant_errors: List[str] = []
        self._reads = 0
        self._hot = sc.loop_hot_per_step
        self._cold = sc.loop_cold_per_step
        self._spy_router()

    def _policy(self) -> OnlinePolicy:
        """Quiet deterministic policy: topology/cadence triggers only (the
        drift/ipt triggers depend on wall-measured values), pressure
        coupling on so overload defers invocations."""
        kw = dict(bootstrap_after_ticks=0, cadence=9_000_000, min_interval=0,
                  dirty_fraction=0.05, drift_l1=9e9, ipt_regression=9e9,
                  defer_above_pressure=0.45)
        kw.update(self.sc.policy_kwargs)
        return OnlinePolicy(**kw)

    def _spy_router(self) -> None:
        """Record (never mask) staleness-bound violations at serve time."""
        router = self.coord.router
        orig = router._serve_slot
        harness = self

        def spy(slot, queries, max_results):
            coord = harness.coord
            if slot != coord.primary_slot:
                f = coord.followers.get(slot)
                if f is not None:
                    bounds = coord.cfg.max_staleness_versions
                    bound = bounds.get(harness._cls,
                                       max(bounds.values(), default=0))
                    if f.version_lag > bound:
                        harness.staleness_violations.append(
                            f"slot {slot} served {harness._cls} at lag "
                            f"{f.version_lag} > bound {bound}")
            return orig(slot, queries, max_results)

        self._cls = "hot"
        router._serve_slot = spy

    # -- event verbs ----------------------------------------------------------
    def _apply_event(self, ev: ChaosEvent) -> None:
        coord, kw = self.coord, ev.kwargs
        log.info("chaos[%s] step-%d event: %s %s", self.sc.name, ev.step,
                 ev.action, kw)
        if ev.action == "arm":
            self.faults.arm(kw["site"], mode=kw.get("mode", "raise"),
                            times=kw.get("times", 1),
                            delay_s=kw.get("delay_s", 0.0))
        elif ev.action == "disarm":
            self.faults.disarm(kw.get("site"))
        elif ev.action == "crash_follower":
            coord.followers[kw["slot"]].crash()
        elif ev.action == "rejoin_follower":
            coord.followers[kw["slot"]].rejoin(
                reuse_state=kw.get("reuse_state", True))
        elif ev.action == "crash_primary":
            coord.crash_primary()
        elif ev.action == "partition_primary":
            coord.partition_primary()
        elif ev.action == "heal_partition":
            coord.hub.partition_primary(False)
        elif ev.action == "force_failover":
            # compress the heartbeat-lapse wait: backdate the last accepted
            # heartbeat so exactly one deterministic failover fires now
            coord.hub.last_heartbeat_mono = -9e9
            coord.cfg.heartbeat_timeout_s = 0.0
            assert coord.check_failover(), "forced failover did not fire"
            coord.cfg.heartbeat_timeout_s = 9e9
        elif ev.action == "rejoin_demoted":
            coord.rejoin_demoted(reuse_state=kw.get("reuse_state", True))
        elif ev.action == "set_budget":
            bo = coord.primary._brownout
            assert bo is not None, "set_budget needs control loops"
            bo.set_budget(kw["cls"], kw["budget_s"])
        elif ev.action == "advance_clock":
            self.clock.advance(kw["dt"])
        elif ev.action == "set_load":
            self._hot = kw.get("hot", self._hot)
            self._cold = kw.get("cold", self._cold)
        else:
            raise ValueError(f"unknown chaos action {ev.action!r}")

    # -- the drive loop -------------------------------------------------------
    def _primary_healthy(self) -> bool:
        return (not self.coord._primary_down
                and not self.coord.hub.primary_partitioned)

    def _drive_step(self, step: int) -> None:
        sc, coord = self.sc, self.coord
        q = PROBE_QUERIES[step % len(PROBE_QUERIES)]
        for _ in range(sc.reads_per_step):
            if self._primary_healthy():
                coord.serve([q], cls="hot")
                self._reads += 1
        # flash-crowd path: classed submissions into the primary queue
        # (brownout sheds these; rejected tickets simply never serve)
        for _ in range(self._hot):
            coord.primary.submit(q, cls="hot")
        for _ in range(self._cold):
            coord.primary.submit(PROBE_QUERIES[(step + 1) % 2], cls="cold")
        r = self.rng.random()
        if r < sc.mutate_prob and self._primary_healthy():
            n = coord.primary.g.n
            if r < sc.mutate_prob / 2:
                coord.submit_mutations(MutationBatch(
                    add_vertex_labels=[int(self.rng.integers(0, 4))],
                    add_edges=[(int(self.rng.integers(0, n)), n)]))
            else:
                coord.submit_mutations(MutationBatch(
                    add_edges=[(int(self.rng.integers(0, sc.n_vertices)),
                                int(self.rng.integers(0, sc.n_vertices)))]))
        coord.pump()
        # drain any loop-submitted backlog this step admitted
        for _ in range(8):
            if coord.primary.requests.depth() == 0:
                break
            coord.pump()
        if self._primary_healthy():
            self.watermark_seq = max(self.watermark_seq,
                                     int(self.coord.primary._applied_seq))

    def run(self) -> ChaosReport:
        """Execute the scenario, quiesce, check every invariant, digest."""
        by_step: Dict[int, List[ChaosEvent]] = {}
        for ev in self.sc.events:
            by_step.setdefault(ev.step, []).append(ev)
        for step in range(self.sc.steps):
            for ev in by_step.get(step, ()):
                self._apply_event(ev)
            self._drive_step(step)
        self.quiesce()
        self._check_invariants()
        report = self._report()
        self.coord.obs.recorder.trigger(f"chaos:{self.sc.name}")
        self.coord.stop()
        return report

    def quiesce(self) -> None:
        """Heal everything and converge: disarm all faults, lift any
        partition, drain queues, catch every live follower up to the
        journal head."""
        coord = self.coord
        self.faults.disarm()
        coord.hub.partition_primary(False)
        # let the brownout re-open fully: clear budgets + enough windows
        bo = coord.primary._brownout
        if bo is not None:
            for cls in list(bo.budgets):
                bo.set_budget(cls, 1e9)
        for _ in range(64):
            coord.pump()
            if bo is not None and coord.primary.requests.shed_level > 0:
                # each pump serves nothing new here; feed one classed probe
                # per shed class so the recovery windows have samples
                for cls in bo.cfg.shed_classes:
                    coord.primary.submit(PROBE_QUERIES[0], cls=cls)
                coord.primary.submit(PROBE_QUERIES[1], cls="hot")
                self.clock.advance(self.control.window_s + 1e-3)
            for f in coord.followers.values():
                if f.alive:
                    f.catch_up()
            if (coord.primary.requests.depth() == 0
                    and coord.primary.ingest.depth() == 0
                    and (bo is None
                         or coord.primary.requests.shed_level == 0)
                    and all(f.applied_seq == coord.hub.primary_seq
                            and f.version_lag == 0
                            for f in coord.followers.values() if f.alive)):
                return
        self.invariant_errors.append("quiesce did not converge in 64 rounds")

    # -- invariants -----------------------------------------------------------
    def _err(self, cond: bool, msg: str) -> None:
        if not cond:
            self.invariant_errors.append(msg)

    def _probe_answers(self, node) -> List:
        if isinstance(node, ServingLoop):
            return node.executor.enumerate_paths_many(
                list(PROBE_QUERIES), max_results=16, part=node.ot.part)
        return node.serve(list(PROBE_QUERIES), max_results=16)

    def _check_invariants(self) -> None:
        coord = self.coord
        # 1. no acked commit lost: everything journaled on a healthy
        # primary survived every crash, partition and promotion
        self._err(int(coord.primary._applied_seq) >= self.watermark_seq,
                  f"acked seq lost: primary at {coord.primary._applied_seq}"
                  f" < watermark {self.watermark_seq}")
        self._err(int(coord.hub.primary_seq) >= self.watermark_seq,
                  "hub head behind the acked watermark")
        # 2. bitwise parity: every live follower equals the primary
        a = coord.primary.ot
        probe = self._probe_answers(coord.primary)
        for slot, f in sorted(coord.followers.items()):
            if not f.alive:
                self.invariant_errors.append(
                    f"follower slot {slot} dead at quiesce")
                continue
            b = f.ot
            pairs = [("labels", a.g.labels, b.g.labels),
                     ("src", a.g.src, b.g.src), ("dst", a.g.dst, b.g.dst),
                     ("row_ptr", a.g.row_ptr, b.g.row_ptr),
                     ("part", a.part, b.part),
                     ("dirty", a._dirty, b._dirty)]
            for nm, x, y in pairs:
                self._err(np.array_equal(x, y),
                          f"slot {slot}: {nm} diverged from primary")
            self._err(a.g.version == b.g.version,
                      f"slot {slot}: graph version diverged")
            self._err(a.invocations == b.invocations,
                      f"slot {slot}: invocation count diverged")
            self._err(a.taper._rng.bit_generator.state
                      == b.taper._rng.bit_generator.state,
                      f"slot {slot}: RNG state diverged")
            self._err(self._probe_answers(f) == probe,
                      f"slot {slot}: probe answers diverged")
        # 3. evidence: the flight recorder holds the whole story
        rec = coord.obs.recorder
        fired = dict(self.faults.fired)
        fault_events = rec.events("fault_fired")
        for site in fired:
            self._err(any(e.get("site") == site for e in fault_events),
                      f"no fault_fired evidence for {site}")
        self._err(len(rec.events("promotion")) == coord.failovers,
                  "promotion events != failovers")
        self._err(len(rec.events("rejoin")) == coord.rejoins,
                  "rejoin events != rejoins")
        trips = self._breaker_trips()
        if trips:
            self._err(bool(rec.events("breaker_transition")),
                      "breakers tripped but no breaker_transition events")
        bo = coord.primary._brownout
        if bo is not None and bo.shed_raises:
            self._err(bool(rec.events("shed_level")),
                      "shed level moved but no shed_level events")

    def _breaker_trips(self) -> int:
        coord = self.coord
        trips = sum(b.trips for b in coord.router._breakers.values())
        trips += coord.primary._backend_breaker.trips
        for f in coord.followers.values():
            if getattr(f.channel, "breaker", None) is not None:
                trips += f.channel.breaker.trips
        return trips

    # -- digest / report ------------------------------------------------------
    def digest(self) -> str:
        """SHA-256 over the quiesced replicated state + probe answers —
        exactly the bytes that must reproduce for a fixed seed."""
        coord = self.coord
        h = hashlib.sha256()
        ot = coord.primary.ot
        for arr in (ot.g.labels, ot.g.src, ot.g.dst, ot.g.row_ptr, ot.part,
                    ot._dirty):
            h.update(np.ascontiguousarray(arr).tobytes())
        meta = (int(ot.g.n), int(ot.g.version), int(ot.invocations),
                int(coord.primary._applied_seq), int(coord.primary._epoch),
                int(coord.failovers), int(coord.rejoins),
                repr(ot.taper._rng.bit_generator.state))
        h.update(repr(meta).encode())
        h.update(repr(self._probe_answers(coord.primary)).encode())
        return h.hexdigest()

    def _report(self) -> ChaosReport:
        coord = self.coord
        bo = coord.primary._brownout
        return ChaosReport(
            scenario=self.sc.name,
            seed=self.sc.seed,
            digest=self.digest(),
            watermark_seq=self.watermark_seq,
            final_seq=int(coord.primary._applied_seq),
            failovers=coord.failovers,
            rejoins=coord.rejoins,
            epoch=int(coord.hub.current_epoch),
            shed_raises=(bo.shed_raises if bo is not None else 0),
            breaker_trips=self._breaker_trips(),
            faults_fired=dict(self.faults.fired),
            staleness_violations=list(self.staleness_violations),
            invariant_errors=list(self.invariant_errors),
            stats=coord.stats(),
        )


# ---------------------------------------------------------------------------
# the canonical scenarios
# ---------------------------------------------------------------------------


def _crash_storm() -> Scenario:
    """Follower crashes/rejoins stacking into a primary crash + failover,
    with apply-path faults firing throughout."""
    return Scenario(
        name="crash_storm", seed=11, steps=26, n_followers=2,
        mutate_prob=0.6,
        events=[
            ChaosEvent(3, "arm", {"site": "replica_apply:replica-2",
                                  "times": 1}),
            # the injected apply fault crashes replica-2; bring it back
            ChaosEvent(6, "rejoin_follower", {"slot": 2,
                                              "reuse_state": False}),
            ChaosEvent(5, "crash_follower", {"slot": 1}),
            ChaosEvent(9, "rejoin_follower", {"slot": 1,
                                              "reuse_state": True}),
            ChaosEvent(12, "crash_follower", {"slot": 1}),
            ChaosEvent(14, "rejoin_follower", {"slot": 1,
                                               "reuse_state": False}),
            ChaosEvent(17, "crash_primary", {}),
            ChaosEvent(17, "force_failover", {}),
            ChaosEvent(20, "rejoin_demoted", {"reuse_state": False}),
        ])


def _slow_follower() -> Scenario:
    """A permanently failing replica: its serve breaker trips, the router
    routes around it and suppresses hedges into it, and the half-open
    probe (virtual-clock cooldown) re-admits it after the fault clears."""
    ctl = ControlConfig(breaker_min_failures=2, breaker_error_rate=0.5,
                        breaker_cooldown_s=5.0)
    return Scenario(
        name="slow_follower", seed=23, steps=24, n_followers=2,
        mutate_prob=0.3, control=ctl,
        # hedging stays on but can never fire on latency (budget huge), so
        # the only routing changes are the deterministic breaker/fault ones
        cluster_kwargs={"slo_budget_s": {"hot": 9e9, "cold": 9e9}},
        events=[
            ChaosEvent(2, "arm", {"site": "replica_serve:replica-1",
                                  "times": -1}),
            # breaker trips after min_failures; cooldown is virtual time
            ChaosEvent(10, "disarm", {"site": "replica_serve:replica-1"}),
            ChaosEvent(12, "advance_clock", {"dt": 6.0}),
        ])


def _flash_crowd() -> Scenario:
    """4x classed overload into the primary queue: the brownout controller
    sheds cold traffic (budget forced breached), pressure defers the
    pending topology invocation, then recovery re-opens admission."""
    ctl = ControlConfig(shed_levels=2, clear_windows=1,
                        min_window_samples=2, window_s=0.25)
    return Scenario(
        name="flash_crowd", seed=37, steps=26, n_followers=1,
        reads_per_step=1, loop_hot_per_step=2, loop_cold_per_step=0,
        mutate_prob=0.5, control=ctl,
        events=[
            # overload: 4x hot + a cold stream, budget forced breached so
            # every controller window raises the shed level one step
            ChaosEvent(6, "set_load", {"hot": 8, "cold": 4}),
            ChaosEvent(6, "set_budget", {"cls": "hot", "budget_s": 1e-6}),
            ChaosEvent(7, "advance_clock", {"dt": 0.3}),
            ChaosEvent(9, "advance_clock", {"dt": 0.3}),
            ChaosEvent(11, "advance_clock", {"dt": 0.3}),
            # recovery: load drops, budget un-breaches, windows elapse
            ChaosEvent(14, "set_load", {"hot": 2, "cold": 1}),
            ChaosEvent(14, "set_budget", {"cls": "hot", "budget_s": 1e9}),
            ChaosEvent(15, "advance_clock", {"dt": 0.3}),
            ChaosEvent(17, "advance_clock", {"dt": 0.3}),
            ChaosEvent(19, "advance_clock", {"dt": 0.3}),
            ChaosEvent(21, "advance_clock", {"dt": 0.3}),
        ])


def _partition_heal() -> Scenario:
    """Primary partitioned mid-write: its late writes fence, a follower
    promotes, the healed zombie rejoins by catch-up replay and converges
    bitwise."""
    return Scenario(
        name="partition_heal", seed=53, steps=24, n_followers=2,
        mutate_prob=0.6,
        events=[
            ChaosEvent(8, "partition_primary", {}),
            ChaosEvent(10, "force_failover", {}),
            ChaosEvent(13, "heal_partition", {}),
            ChaosEvent(14, "rejoin_demoted", {"reuse_state": True}),
        ])


SCENARIOS: Dict[str, Callable[[], Scenario]] = {
    "crash_storm": _crash_storm,
    "slow_follower": _slow_follower,
    "flash_crowd": _flash_crowd,
    "partition_heal": _partition_heal,
}


def scenario(name: str) -> Scenario:
    """A fresh instance of one canonical scenario by name."""
    try:
        return SCENARIOS[name]()
    except KeyError:
        raise ValueError(f"unknown scenario {name!r}; have "
                         f"{sorted(SCENARIOS)}") from None


def run_scenario(directory, name: str,
                 device: DeviceLike = None) -> ChaosReport:
    """Convenience: build a harness under ``directory`` and run one
    canonical scenario end to end, its cluster on ``device``."""
    return ChaosHarness(directory, scenario(name), device=device).run()
