"""Request/invocation tracing: trace ids, spans, sampling.

A **trace** is the causal story of one unit of work — a served request
(queue admission → micro-batch drain → enum sweeps → reply), a TAPER
invocation (input snapshot → field depth steps → swap iterations → commit
→ shard re-deal), an ingest group (journal append → apply → ship →
follower apply), or a failover (crash → fence → promotion → first
answer).  A trace is identified by a ``trace_id`` string; its **spans**
are named intervals on the monotonic clock, each carrying a
``span_id``/``parent_id`` pair and free-form key/value attributes.  Trace
ids travel across nodes on ``ServeTicket``s and piggybacked inside
replication-frame payloads, so a follower's apply or a router's
first-answer-after-failover *joins* the originating trace
(:meth:`Tracer.join`) instead of starting a disconnected one.

The hot-path contract is *pay nothing when off*:

* ``Tracer(enabled=False)`` (the compile-out-style fast path) makes
  :meth:`new_trace` return the shared :data:`NOOP_TRACE` and
  :meth:`start` the shared :data:`NOOP_SPAN` after a single attribute
  check — no allocation, no lock;
* ``sample_rate`` < 1 makes the *sampling decision once per trace* at
  :meth:`new_trace` (deterministic 1-in-``round(1/rate)`` counting, so
  runs are reproducible); every span of an unsampled trace is the no-op
  singleton.

Finished spans land in a bounded ring (oldest evicted) and export as
dicts (:meth:`Tracer.spans`) or JSONL (:meth:`Tracer.export_jsonl`).
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["NOOP_SPAN", "NOOP_TRACE", "Span", "TraceContext", "Tracer"]


class TraceContext:
    """Immutable (trace id, current parent span id, sampled) triple.

    Carried on tickets and frame payloads; ``sampled=False`` contexts
    (including :data:`NOOP_TRACE`) produce only no-op spans."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str = "", span_id: int = 0,
                 sampled: bool = False):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"TraceContext({self.trace_id!r}, span={self.span_id}, "
                f"sampled={self.sampled})")


NOOP_TRACE = TraceContext()


class Span:
    """One named interval of a sampled trace.  Usable as a context manager
    (``with tracer.start(...) as sp:``) or via explicit :meth:`end`."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t0", "t1",
                 "attrs", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 span_id: int, parent_id: int, attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = time.monotonic()
        self.t1: Optional[float] = None
        self.attrs = attrs

    @property
    def t_wall(self) -> float:
        """Wall-clock start, derived from the tracer's clock anchor (no
        per-span ``time.time()`` syscall on the hot path)."""
        return self._tracer._wall0 + self.t0

    def set(self, **attrs) -> "Span":
        """Attach key/value attributes; returns self for chaining."""
        self.attrs.update(attrs)
        return self

    def context(self) -> TraceContext:
        """A child context: same trace, this span as the parent."""
        return TraceContext(self.trace_id, self.span_id, True)

    def end(self, **attrs) -> None:
        """Close the span (idempotent) and hand it to the tracer's ring."""
        if self.t1 is not None:
            return
        if attrs:
            self.attrs.update(attrs)
        self.t1 = time.monotonic()
        self._tracer._record(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        self.end()
        return False

    def to_dict(self) -> Dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "t0": self.t0,
            "t1": self.t1,
            "duration_s": (None if self.t1 is None else self.t1 - self.t0),
            "wall": self.t_wall,
            "attrs": dict(self.attrs),
        }


class _NoopSpan:
    """Shared do-nothing span for disabled tracers / unsampled traces."""

    __slots__ = ()

    def set(self, **attrs) -> "_NoopSpan":
        return self

    def context(self) -> TraceContext:
        return NOOP_TRACE

    def end(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


class Tracer:
    """Span factory + bounded ring of finished spans (module doc)."""

    def __init__(self, enabled: bool = True, sample_rate: float = 1.0,
                 capacity: int = 8192, node: str = "n0"):
        self.enabled = bool(enabled)
        self.sample_rate = float(sample_rate)
        self.node = str(node)
        self._spans: "deque[Span]" = deque(maxlen=int(capacity))
        #: wall = monotonic + anchor: one syscall pair here, none per span
        self._wall0 = time.time() - time.monotonic()
        self._trace_seq = itertools.count(1)
        self._span_seq = itertools.count(1)
        self.sampled_traces = 0
        self.unsampled_traces = 0
        #: sampling period resolved once: every Nth trace is sampled
        self._period = (1 if self.sample_rate >= 1.0
                        else (0 if self.sample_rate <= 0.0
                              else max(1, round(1.0 / self.sample_rate))))

    # -- trace lifecycle ------------------------------------------------------
    def new_trace(self, force: bool = False) -> TraceContext:
        """Open a new trace; the sampling decision is made here, once.
        ``force=True`` bypasses sampling (rare, load-bearing traces:
        invocations, failovers) but still honours ``enabled=False``."""
        if not self.enabled:
            return NOOP_TRACE
        n = next(self._trace_seq)
        if not force:
            if self._period == 0 or (n - 1) % self._period:
                self.unsampled_traces += 1
                return NOOP_TRACE
        self.sampled_traces += 1
        return TraceContext(f"t-{self.node}-{n:08d}", 0, True)

    def join(self, trace_id: Optional[str]) -> TraceContext:
        """Adopt a trace id that arrived from another node (ticket, frame
        payload).  The originating tracer already made the sampling
        decision — an id is only ever shipped for sampled traces."""
        if not self.enabled or not trace_id:
            return NOOP_TRACE
        return TraceContext(str(trace_id), 0, True)

    # -- spans ----------------------------------------------------------------
    def start(self, name: str, ctx: TraceContext, **attrs):
        """Open a span under ``ctx`` (its ``span_id`` is the parent)."""
        if not self.enabled or not ctx.sampled:
            return NOOP_SPAN
        return Span(self, name, ctx.trace_id, next(self._span_seq),
                    ctx.span_id, attrs)

    def event(self, name: str, ctx: TraceContext, **attrs) -> None:
        """Record an instant (zero-duration) span — a point-in-time marker
        such as a per-depth halo accounting step or a fence advancing."""
        if not self.enabled or not ctx.sampled:
            return
        sp = Span(self, name, ctx.trace_id, next(self._span_seq),
                  ctx.span_id, attrs)
        sp.t1 = sp.t0
        self._record(sp)

    def _record(self, span: Span) -> None:
        # deque.append is atomic under the GIL; eviction at maxlen is the
        # ring semantics we want
        self._spans.append(span)

    # -- export ---------------------------------------------------------------
    def spans(self, trace_id: Optional[str] = None,
              name: Optional[str] = None) -> List[Dict[str, Any]]:
        """Finished spans (oldest-evicted ring), sorted by start time;
        optionally filtered by trace id and/or span name."""
        out = [s for s in list(self._spans)
               if (trace_id is None or s.trace_id == trace_id)
               and (name is None or s.name == name)]
        out.sort(key=lambda s: (s.t0, s.span_id))
        return [s.to_dict() for s in out]

    def trace_ids(self) -> List[str]:
        seen: Dict[str, None] = {}
        for s in list(self._spans):
            seen.setdefault(s.trace_id)
        return list(seen)

    def export_jsonl(self, path) -> int:
        """Write every retained span as one JSON object per line; returns
        the number of spans written."""
        from repro_torch.utils.logging import json_default

        rows = self.spans()
        with open(path, "w") as fh:
            for r in rows:
                fh.write(json.dumps(r, default=json_default) + "\n")
        return len(rows)
