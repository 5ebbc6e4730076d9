"""Closed-loop overload protection: the observe→decide→act layer.

Observability made the serving cluster observable — per-SLO-class latency
histograms, degradation events, a flight recorder — but every protective
mechanism still ran on *static* thresholds: fixed hedge deadlines, a fixed
backend strike count, heat-only admission.  This module closes the loop
(Loom / AWAPart's argument that online partitioning must feed measurement
back into serving decisions, PAPERS.md): the live registry signals drive
admission, hedging, degradation and invocation cadence.

Four control loops, composed by ``ServingLoop`` / ``ClusterCoordinator``:

* **SLO brownout admission** (:class:`BrownoutController`) — reads each
  class's live latency quantile from its registry histogram through a
  *windowed* bucket-quantile estimator (:class:`WindowedQuantile`: the
  delta of cumulative bucket counts between controller ticks, so the
  estimate reflects the current window, not the lifetime average).  A
  breach of the class budget raises the :class:`RequestQueue` shed level
  one step per controller window — progressively shrinking the admission
  zone for shed classes until they are rejected outright — and recovery
  lowers it hysteretically: the estimate must sit below
  ``clear_ratio * budget`` for ``clear_windows`` consecutive windows
  before each step back down.
* **adaptive hedging** (:class:`HedgeController`) — the router's hedge
  deadline becomes ``clamp(quantile * hedge_factor)`` of the same
  windowed estimate, bounded above by the static ``slo_budget_s`` (the
  old deadline is the worst case, never exceeded) and below by
  ``hedge_floor_s`` — so an uncongested class hedges early at its real
  tail, a congested one does not hedge-storm itself.
* **circuit breakers** (:class:`Breaker`) — one closed/open/half-open
  state machine wraps every unreliable dependency: follower serve paths
  (the router routes around an open replica), ship-channel sends (an
  open link fast-fails instead of queueing into a blackhole; the
  follower's tail resync repairs the gap) and the field-backend ladder
  (error-rate-over-window tripping replaces the bare consecutive-failure
  count).  Tripping needs ``min_failures`` in the window *and* the
  window's failure rate at ``error_rate`` — or ``min_failures``
  consecutive trailing failures, preserving the ladder's historic
  strike-count behaviour as the degenerate case.  Every transition is
  recorded to the flight recorder.
* **pressure-aware invocation cadence** — :func:`serve_pressure` folds
  queue depth, shed level and invocation wall cost into one [0, 1]
  signal the loop passes to ``OnlineTaper.poll``; the policy defers
  TAPER invocations above ``OnlinePolicy.defer_above_pressure`` and
  relaxes the ipt-regression threshold below
  ``accelerate_below_pressure`` (idle capacity is the cheapest time to
  repartition).

Every clock here is injectable (``clock=``) so ``serve.chaos`` can drive
the controllers on a deterministic virtual clock — the chaos scenarios'
bit-reproducibility depends on no control decision reading the wall.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.utils import get_logger

log = get_logger("serve.control")

__all__ = [
    "Breaker", "BrownoutController", "ControlConfig", "HedgeController",
    "WindowedQuantile", "serve_pressure",
]

#: breaker states
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class Breaker:
    """Closed/open/half-open circuit breaker (module doc).

    * **closed** — calls flow; outcomes fill a bounded window.  The
      breaker opens when the window holds ``min_failures`` failures at a
      failure rate of at least ``error_rate``, or when the last
      ``min_failures`` outcomes were all failures (the strike-count
      degenerate case).
    * **open** — :meth:`allow` refuses for ``cooldown_s`` (doubling per
      consecutive re-open up to ``cooldown_max_s``), then transitions to
      half-open.
    * **half-open** — probes are allowed through; ``probe_successes``
      consecutive successes close the breaker (window cleared, cooldown
      reset), one failure re-opens it with a doubled cooldown.

    Thread-compatible with the serving loop's single-mutator call sites;
    transitions are recorded to ``recorder`` as ``breaker_transition``
    events.  ``clock`` is injectable for deterministic chaos drills.
    """

    def __init__(self, name: str, window: int = 16, min_failures: int = 4,
                 error_rate: float = 0.5, cooldown_s: float = 0.5,
                 cooldown_max_s: float = 30.0, probe_successes: int = 1,
                 recorder=None,
                 clock: Callable[[], float] = time.monotonic):
        if window < 1 or min_failures < 1:
            raise ValueError("window and min_failures must be >= 1")
        self.name = str(name)
        self.window = int(window)
        self.min_failures = int(min_failures)
        self.error_rate = float(error_rate)
        self.base_cooldown_s = float(cooldown_s)
        self.cooldown_max_s = float(cooldown_max_s)
        self.probe_successes = int(probe_successes)
        self.recorder = recorder
        self.clock = clock
        self.state = CLOSED
        self._outcomes: List[bool] = []   # True = success
        self._opened_at = 0.0
        self._cooldown_s = float(cooldown_s)
        self._probe_ok = 0
        self.trips = 0
        self.closes = 0
        self.fast_failures = 0

    # -- state machine --------------------------------------------------------
    def _transition(self, to: str, **fields) -> None:
        frm, self.state = self.state, to
        if self.recorder is not None:
            self.recorder.record("breaker_transition", breaker=self.name,
                                 frm=frm, to=to, **fields)
        log.info("breaker %s: %s -> %s", self.name, frm, to)

    def _should_trip(self) -> bool:
        fails = sum(1 for ok in self._outcomes if not ok)
        if fails < self.min_failures:
            return False
        if fails / len(self._outcomes) >= self.error_rate:
            return True
        tail = 0
        for ok in reversed(self._outcomes):
            if ok:
                break
            tail += 1
        return tail >= self.min_failures

    def _open(self) -> None:
        self.trips += 1
        self._opened_at = self.clock()
        self._probe_ok = 0
        self._transition(OPEN, cooldown_s=self._cooldown_s)

    def allow(self) -> bool:
        """True when a call may proceed.  An open breaker whose cooldown
        has elapsed moves to half-open and lets the probe through."""
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            if self.clock() - self._opened_at < self._cooldown_s:
                self.fast_failures += 1
                return False
            self._transition(HALF_OPEN)
        return True  # half-open: probe traffic flows

    def record_success(self) -> None:
        if self.state == HALF_OPEN:
            self._probe_ok += 1
            if self._probe_ok >= self.probe_successes:
                self._outcomes.clear()
                self._cooldown_s = self.base_cooldown_s
                self.closes += 1
                self._transition(CLOSED)
            return
        if self.state == OPEN:
            return  # a straggler finishing after the trip
        self._outcomes.append(True)
        del self._outcomes[:-self.window]

    def record_failure(self) -> bool:
        """Record one failure; returns True when this call tripped the
        breaker closed→open (the ladder demotes on exactly that edge)."""
        if self.state == HALF_OPEN:
            # failed probe: back to open with a doubled cooldown, so a
            # flapping dependency converges onto long re-test intervals
            self._cooldown_s = min(self._cooldown_s * 2, self.cooldown_max_s)
            self._open()
            return False
        if self.state == OPEN:
            return False
        self._outcomes.append(False)
        del self._outcomes[:-self.window]
        if self._should_trip():
            self._open()
            return True
        return False

    def reset(self) -> None:
        """Forget history and close (a new ladder rung starts fresh)."""
        self._outcomes.clear()
        self._probe_ok = 0
        self._cooldown_s = self.base_cooldown_s
        if self.state != CLOSED:
            self._transition(CLOSED, reset=True)

    def stats(self) -> Dict[str, Any]:
        return {"state": self.state, "trips": self.trips,
                "closes": self.closes, "fast_failures": self.fast_failures}


class WindowedQuantile:
    """Bucket-quantile estimator over the *recent window* of a cumulative
    :class:`~repro_torch.obs.registry.Histogram`.

    A registry histogram accumulates forever, so its lifetime quantile
    lags the live tail by however much history it holds.  This estimator
    snapshots the per-bucket counts at each :meth:`advance` (one
    controller window) and interpolates quantiles over the *delta* —
    exactly the samples observed since the last tick."""

    def __init__(self, hist):
        self.hist = hist
        self._base: List[int] = list(hist.counts)

    def advance(self) -> None:
        """Start a new window at the histogram's current position."""
        self._base = list(self.hist.counts)

    @property
    def count(self) -> int:
        """Samples observed in the current window."""
        return sum(self.hist.counts) - sum(self._base)

    def quantile(self, q: float) -> Optional[float]:
        """Interpolated quantile of the window, or None when empty."""
        counts = [c - b for c, b in zip(self.hist.counts, self._base)]
        total = sum(counts)
        if total <= 0:
            return None
        bounds = self.hist.bounds
        target = q * total
        acc = 0
        lo = 0.0
        for i, c in enumerate(counts):
            if acc + c >= target and c:
                hi = bounds[i] if i < len(bounds) else bounds[-1]
                frac = (target - acc) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            acc += c
            if i < len(bounds):
                lo = bounds[i]
        return lo


@dataclass
class ControlConfig:
    """Knobs for the serving stack's control loops (module doc)."""

    #: per-SLO-class latency budget (seconds) the brownout loop defends;
    #: serving loops default it, the cluster reuses ``slo_budget_s``
    slo_budget_s: Dict[str, float] = field(
        default_factory=lambda: {"hot": 0.05, "cold": 0.5})
    #: controller tick period (seconds of ``clock``)
    window_s: float = 0.25
    #: the quantile each class budget is enforced against
    breach_quantile: float = 0.99
    #: minimum window samples before a class's estimate is trusted
    min_window_samples: int = 8
    #: shed ladder height: level ``shed_levels`` rejects shed classes
    #: outright, intermediate levels shrink their admission zone
    shed_levels: int = 4
    #: classes the brownout loop may shed (never the hot class)
    shed_classes: Tuple[str, ...] = ("cold",)
    #: hysteresis: the estimate must sit below ``clear_ratio * budget``
    #: for ``clear_windows`` consecutive windows per step back down
    clear_ratio: float = 0.7
    clear_windows: int = 2
    # -- adaptive hedging ------------------------------------------------------
    hedge_quantile: float = 0.95
    #: deadline = clamp(quantile * hedge_factor, hedge_floor_s, budget)
    hedge_factor: float = 1.5
    hedge_floor_s: float = 1e-3
    # -- circuit breakers ------------------------------------------------------
    breaker_window: int = 16
    breaker_min_failures: int = 3
    breaker_error_rate: float = 0.5
    breaker_cooldown_s: float = 0.5
    # -- serve pressure --------------------------------------------------------
    #: weights folding queue depth / shed level / invocation wall cost
    #: into the [0, 1] pressure signal (see :func:`serve_pressure`)
    pressure_depth_weight: float = 0.5
    pressure_shed_weight: float = 0.5
    pressure_invocation_weight: float = 0.25
    #: deterministic drills replace the wall clock for every controller
    #: and breaker built from this config
    clock: Optional[Callable[[], float]] = None

    def resolved_clock(self) -> Callable[[], float]:
        return self.clock if self.clock is not None else time.monotonic


def serve_pressure(depth_frac: float, shed_frac: float,
                   invocation_frac: float,
                   cfg: Optional[ControlConfig] = None) -> float:
    """Fold the three overload signals into one [0, 1] pressure value:
    request-queue fullness, brownout shed depth, and the invocation wall
    cost relative to its watchdog budget."""
    c = cfg or ControlConfig()
    p = (c.pressure_depth_weight * max(0.0, min(1.0, depth_frac))
         + c.pressure_shed_weight * max(0.0, min(1.0, shed_frac))
         + c.pressure_invocation_weight
         * max(0.0, min(1.0, invocation_frac)))
    return max(0.0, min(1.0, p))


class _ClassWindows:
    """Shared per-class windowed estimators over registry histograms."""

    def __init__(self, registry, metric: str, cfg: ControlConfig):
        self.registry = registry
        self.metric = metric
        self.cfg = cfg
        self._windows: Dict[str, WindowedQuantile] = {}

    def window(self, cls: str) -> WindowedQuantile:
        w = self._windows.get(cls)
        if w is None:
            w = self._windows[cls] = WindowedQuantile(
                self.registry.histogram(self.metric, cls=cls))
        return w

    def advance(self) -> None:
        for w in self._windows.values():
            w.advance()


class BrownoutController:
    """SLO-aware brownout admission (module doc).

    Owns the :class:`RequestQueue`'s shed level: each controller window
    it estimates every budgeted class's ``breach_quantile`` latency over
    the window; any breach raises the shed level one step, and only
    ``clear_windows`` consecutive all-clear windows (every observed
    estimate below ``clear_ratio * budget``) lower it one step —
    admission re-opens hysteretically, never flaps."""

    def __init__(self, queue, registry, cfg: Optional[ControlConfig] = None,
                 metric: str = "request_latency_s", recorder=None):
        self.cfg = cfg or ControlConfig()
        self.queue = queue
        self.recorder = recorder
        self.clock = self.cfg.resolved_clock()
        self.budgets: Dict[str, float] = dict(self.cfg.slo_budget_s)
        self._cw = _ClassWindows(registry, metric, self.cfg)
        for cls in self.budgets:
            # open each class window now, not lazily at the first tick —
            # samples observed before then belong to the first window
            self._cw.window(cls)
        self._last_tick = self.clock()
        self._clear_streak = 0
        self.ticks = 0
        self.shed_raises = 0
        self.shed_drops = 0
        #: gauge mirror of the queue's shed level for dashboards
        self._gauge = registry.gauge("shed_level")
        queue.max_shed_level = self.cfg.shed_levels
        queue.shed_classes = tuple(self.cfg.shed_classes)

    @property
    def shed_level(self) -> int:
        return self.queue.shed_level

    def set_budget(self, cls: str, budget_s: float) -> None:
        """Reconfigure one class's budget live (chaos drills and dynamic
        SLO changes both go through here)."""
        self.budgets[cls] = float(budget_s)

    def maybe_tick(self) -> Optional[int]:
        """Run one controller window if ``window_s`` has elapsed; returns
        the new shed level when it changed, else None."""
        now = self.clock()
        if now - self._last_tick < self.cfg.window_s:
            return None
        self._last_tick = now
        return self.tick()

    def tick(self) -> Optional[int]:
        """Evaluate one window now (unconditionally).  Returns the new
        shed level when it changed, else None."""
        self.ticks += 1
        cfg = self.cfg
        breach = None
        all_clear = True
        observed = False
        for cls, budget in self.budgets.items():
            w = self._cw.window(cls)
            if w.count < cfg.min_window_samples:
                continue
            p = w.quantile(cfg.breach_quantile)
            if p is None:
                continue
            observed = True
            if p > budget:
                breach = (cls, p, budget)
            if p >= cfg.clear_ratio * budget:
                all_clear = False
        self._cw.advance()
        level = self.queue.shed_level
        if breach is not None:
            self._clear_streak = 0
            if level < cfg.shed_levels:
                return self._set_level(level + 1, raised=True,
                                       cls=breach[0], quantile_s=breach[1],
                                       budget_s=breach[2])
            return None
        if not observed or level == 0:
            # an idle window is not evidence of recovery
            return None
        if not all_clear:
            self._clear_streak = 0
            return None
        self._clear_streak += 1
        if self._clear_streak < cfg.clear_windows:
            return None
        self._clear_streak = 0
        return self._set_level(level - 1, raised=False)

    def _set_level(self, level: int, raised: bool, **fields) -> int:
        self.queue.set_shed_level(level)
        self._gauge.set(level)
        if raised:
            self.shed_raises += 1
        else:
            self.shed_drops += 1
        if self.recorder is not None:
            self.recorder.record("shed_level", level=level,
                                 raised=raised, **fields)
        log.info("brownout shed level -> %d (%s)", level,
                 "breach" if raised else "recovery")
        return level

    def stats(self) -> Dict[str, Any]:
        return {"shed_level": self.queue.shed_level, "ticks": self.ticks,
                "shed_raises": self.shed_raises,
                "shed_drops": self.shed_drops}


class HedgeController:
    """Adaptive hedge deadlines from live per-class latency quantiles
    (module doc).  Windows advance on their own ``window_s`` cadence so
    the deadline tracks the *recent* tail, clamped into
    ``[hedge_floor_s, budget]`` — the static budget stays the worst-case
    deadline, so adaptivity can only hedge earlier, never later."""

    def __init__(self, registry, cfg: Optional[ControlConfig] = None,
                 metric: str = "router_latency_s"):
        self.cfg = cfg or ControlConfig()
        self.clock = self.cfg.resolved_clock()
        self._cw = _ClassWindows(registry, metric, self.cfg)
        #: the previous full window's quantile per class (the live window
        #: is still filling, so decisions read the last complete one)
        self._latest: Dict[str, Optional[float]] = {}
        self._last_advance = self.clock()

    def _maybe_advance(self) -> None:
        now = self.clock()
        if now - self._last_advance < self.cfg.window_s:
            return
        self._last_advance = now
        for cls, w in self._cw._windows.items():
            if w.count >= self.cfg.min_window_samples:
                self._latest[cls] = w.quantile(self.cfg.hedge_quantile)
        self._cw.advance()

    def deadline(self, cls: str, budget: Optional[float]) -> Optional[float]:
        """The hedge deadline for ``cls``: the adaptive estimate when one
        exists, else the static budget (also the upper clamp)."""
        self._cw.window(cls)  # ensure the class is tracked
        self._maybe_advance()
        if budget is None:
            return None
        q = self._latest.get(cls)
        if q is None:
            return budget
        return min(budget, max(self.cfg.hedge_floor_s,
                               q * self.cfg.hedge_factor))
