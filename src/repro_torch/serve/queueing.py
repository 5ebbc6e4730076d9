"""Bounded admission queue with micro-batching and backpressure.

The request path of the serving subsystem (the JAX package's ``serve/README.md``): callers
:meth:`RequestQueue.submit` individual RPQ requests; admission is O(1) and
either returns a :class:`ServeTicket` (a completion handle the caller can
wait on) or — when the queue is at ``max_depth`` — a :class:`Rejection`
carrying a *retry hint*: the estimated time for the current backlog to
drain, derived from an EWMA of recent per-request service time.  Rejecting
at admission instead of queueing unboundedly is what turns an overloaded
serving loop into backpressure the client can act on.

**Admission classes.**  An optional ``admission_weight`` hook (the serving
loop wires it to the ``FrequencySketch``'s per-query frequency) grades
backpressure by query heat — hot queries are cheap to serve (their
enumeration plan and traversal-count DP rows are warm), so under pressure
they are admitted ahead of cold ones: the top ``hot_reserve_frac`` of the
queue only admits queries at least as hot as the EWMA of recently admitted
weights (colder ones get a ``"cold_backpressure"`` rejection), and every
rejection's retry hint is scaled by relative heat — hot queries are told
to come back sooner, cold ones later, so the retry traffic itself arrives
pre-sorted by admission priority.  Without the hook behaviour is exactly
the unweighted FIFO queue.

**Brownout shedding.**  The queue also carries a controller-driven *shed
level* (``serve.control.BrownoutController`` owns it; the queue itself
never changes it).  Each request declares an SLO class (``cls=``,
default ``"hot"``); at shed level ``L`` of ``max_shed_level``, classes in
``shed_classes`` see their admission zone shrink to the bottom
``1 - L/max_shed_level`` of the queue — and at the top level they are
rejected outright — with a ``"brownout"`` rejection whose retry hint is
stretched by ``1 + L``, so shed traffic backs off harder the deeper the
brownout.  Level 0 (the default) is byte-identical to the un-shed queue.

The serving loop drains requests in *micro-batches*
(:meth:`RequestQueue.take_batch`): up to ``max_batch`` requests leave
together so the executor can share per-query enumeration work across the
batch (``QueryExecutor.enumerate_paths_many``).  Draining is multi-worker
safe: ``take_batch`` removes its batch atomically under the queue lock, so
N executor workers (``ServeLoopConfig.n_workers``) pull disjoint batches
from the one shared queue with no further coordination — each ticket is
completed by exactly one worker."""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple, Union

from repro_torch.core.rpq import RPQ
from repro_torch.obs.trace import NOOP_SPAN, NOOP_TRACE, TraceContext


@dataclass
class Rejection:
    """Admission refused: the queue is full.  ``retry_after_s`` estimates
    when the backlog will have drained enough to admit again."""

    retry_after_s: float
    queue_depth: int
    reason: str = "queue_full"

    @property
    def accepted(self) -> bool:
        return False


@dataclass
class ServeTicket:
    """Completion handle for one admitted request."""

    query: RPQ
    submitted_s: float
    #: SLO class declared at submit (brownout shedding + per-class SLOs)
    cls: str = "hot"
    done: threading.Event = field(default_factory=threading.Event)
    paths: Optional[List[Tuple[int, ...]]] = None
    ipt: int = 0
    latency_s: float = 0.0
    #: trace context opened at admission; carried with the ticket so the
    #: drain/enumeration spans on another thread join the request's trace
    trace: TraceContext = NOOP_TRACE
    #: the root "request" span; ended (with latency/ipt attrs) at complete()
    span: Any = NOOP_SPAN

    @property
    def accepted(self) -> bool:
        return True

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.done.wait(timeout)

    def complete(self, paths, ipt: int) -> None:
        self.paths = paths
        self.ipt = int(ipt)
        self.latency_s = time.perf_counter() - self.submitted_s
        self.span.end(latency_s=self.latency_s, ipt=self.ipt,
                      n_paths=len(paths) if paths is not None else 0)
        self.done.set()


class RequestQueue:
    """Thread-safe bounded FIFO of :class:`ServeTicket` with micro-batch
    draining, a service-rate EWMA for retry hints, and optional
    frequency-weighted admission classes (module docstring)."""

    #: retry-hint scale clamp: a hint is never stretched/compressed by more
    #: than this factor relative to the unweighted backlog-drain estimate
    HINT_SCALE_MAX = 4.0

    def __init__(self, max_depth: int = 256, ewma_alpha: float = 0.2,
                 initial_service_s: float = 1e-3,
                 admission_weight: Optional[Callable[[RPQ], float]] = None,
                 hot_reserve_frac: float = 0.25):
        if max_depth < 1:
            raise ValueError("max_depth must be >= 1")
        self.max_depth = int(max_depth)
        self._items: List[ServeTicket] = []
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._ewma_alpha = float(ewma_alpha)
        # seeded optimistic; the first completed batches correct it
        self._service_s = float(initial_service_s)
        self.admission_weight = admission_weight
        self.hot_reserve_frac = float(hot_reserve_frac)
        # EWMA of admitted weights = the hot/cold watershed; starts at 0 so
        # an unwarmed sketch (every weight 0) treats all queries as hot
        self._weight_ewma = 0.0
        #: brownout ladder (owned by ``serve.control.BrownoutController``):
        #: at level L of max, ``shed_classes`` admission shrinks to the
        #: bottom 1 - L/max of the queue; the top level rejects outright
        self.shed_level = 0
        self.max_shed_level = 4
        self.shed_classes: Tuple[str, ...] = ("cold",)
        self.submitted = 0
        self.rejected = 0
        self.rejected_cold = 0
        self.rejected_brownout = 0
        #: observability hooks (wired by the serving loop when obs is on):
        #: tracer opens a trace per admitted request, recorder captures
        #: admission rejects as flight-recorder events
        self.tracer = None
        self.recorder = None

    def _hint_scale(self, weight: Optional[float]) -> float:
        """Retry-hint multiplier from relative heat: hot queries (above the
        admitted-weight EWMA) retry sooner, cold ones later."""
        if weight is None or self._weight_ewma <= 0.0:
            return 1.0
        ratio = self._weight_ewma / max(weight, 1e-9)
        return min(max(ratio, 1.0 / self.HINT_SCALE_MAX), self.HINT_SCALE_MAX)

    def set_shed_level(self, level: int) -> None:
        """Set the brownout shed level (clamped into [0, max_shed_level]).
        Called by the brownout controller, never by the queue itself."""
        with self._lock:
            self.shed_level = max(0, min(int(level), self.max_shed_level))

    # -- admission -----------------------------------------------------------
    def submit(self, query: RPQ,
               cls: str = "hot") -> Union[ServeTicket, Rejection]:
        """Admit one request or reject with a backlog-drain retry hint
        (weighted by the query's sketch frequency when the queue has an
        ``admission_weight`` hook; shed per-class under brownout)."""
        w = (self.admission_weight(query)
             if self.admission_weight is not None else None)
        with self._lock:
            depth = len(self._items)
            hint = max(depth, 1) * self._service_s * self._hint_scale(w)
            lvl = self.shed_level
            if lvl > 0 and cls in self.shed_classes:
                # brownout: shed classes admit only into the bottom
                # 1 - lvl/max of the queue; the top level sheds outright
                frac = lvl / max(self.max_shed_level, 1)
                if lvl >= self.max_shed_level or depth >= self.max_depth * (
                        1.0 - frac):
                    self.rejected += 1
                    self.rejected_brownout += 1
                    hint *= 1 + lvl
                    if self.recorder is not None:
                        self.recorder.record("admission_reject",
                                             reason="brownout", cls=cls,
                                             shed_level=lvl,
                                             queue_depth=depth,
                                             retry_after_s=hint)
                    return Rejection(retry_after_s=hint, queue_depth=depth,
                                     reason="brownout")
            if depth >= self.max_depth:
                self.rejected += 1
                if self.recorder is not None:
                    self.recorder.record("admission_reject",
                                         reason="queue_full",
                                         queue_depth=depth,
                                         retry_after_s=hint)
                return Rejection(retry_after_s=hint, queue_depth=depth)
            if (w is not None
                    and depth >= self.max_depth * (1 - self.hot_reserve_frac)
                    and w < self._weight_ewma):
                # the reserve zone only admits hot queries: their plans/DP
                # rows are warm, so they clear backlog fastest
                self.rejected += 1
                self.rejected_cold += 1
                if self.recorder is not None:
                    self.recorder.record("admission_reject",
                                         reason="cold_backpressure",
                                         queue_depth=depth,
                                         retry_after_s=hint)
                return Rejection(retry_after_s=hint, queue_depth=depth,
                                 reason="cold_backpressure")
            if w is not None:
                a = self._ewma_alpha
                self._weight_ewma = (1 - a) * self._weight_ewma + a * w
            ticket = ServeTicket(query=query, cls=cls,
                                 submitted_s=time.perf_counter())
            if self.tracer is not None:
                ctx = self.tracer.new_trace()
                if ctx.sampled:
                    # the raw query object: stringified only at export
                    # (to_text() per admission would tax the hot path)
                    span = self.tracer.start("request", ctx,
                                             query=query,
                                             queue_depth=depth)
                    ticket.trace = span.context()
                    ticket.span = span
            self._items.append(ticket)
            self.submitted += 1
            self._nonempty.notify()
            return ticket

    # -- draining ------------------------------------------------------------
    def take_batch(self, max_batch: int,
                   timeout: Optional[float] = 0.0) -> List[ServeTicket]:
        """Remove and return up to ``max_batch`` requests (FIFO order).

        ``timeout=0`` (the default) polls; ``timeout > 0`` blocks up to that
        many seconds for the queue to become non-empty; ``timeout=None``
        blocks until a request arrives.  Returns whatever is queued the
        moment it is non-empty — micro-batches fill from backlog, they do
        not wait to fill up, so an idle system serves single requests at
        low latency.  Atomic under the queue lock: concurrent workers get
        disjoint batches.
        """
        with self._nonempty:
            if not self._items:
                if timeout is None:
                    while not self._items:
                        self._nonempty.wait()
                elif timeout > 0:
                    self._nonempty.wait(timeout)
            batch = self._items[:max_batch]
            del self._items[:len(batch)]
            return batch

    def record_service_time(self, per_request_s: float) -> None:
        """Fold one batch's measured per-request service time into the EWMA
        that backs admission retry hints."""
        a = self._ewma_alpha
        with self._lock:
            self._service_s = (1 - a) * self._service_s + a * float(
                per_request_s)

    def depth(self) -> int:
        with self._lock:
            return len(self._items)

    @property
    def estimated_service_s(self) -> float:
        return self._service_s
