"""Observability: tracing, flight recorder, metrics registry.

One :class:`Observability` bundle carries the three pillars the serving
cluster shares:

* :class:`~repro_torch.obs.trace.Tracer` — request/invocation traces
  (sampled, cross-node via ticket/frame trace ids);
* :class:`~repro_torch.obs.recorder.FlightRecorder` — bounded ring of
  structured events with triggered JSONL dumps;
* :class:`~repro_torch.obs.registry.Registry` — named counters / gauges /
  histograms + the per-component ``collect()`` protocol, exported as
  Prometheus text or JSONL.

A loop, coordinator, or test creates one bundle and threads it through
``ServeLoopConfig.obs`` / ``ClusterConfig.obs``; everything downstream
(queue, fault injector, taper, hub, followers, router) borrows the same
tracer/recorder/registry so spans and events from every component land
in one causally ordered place.  :meth:`Observability.disabled` returns a
shared all-off bundle whose members short-circuit after one attribute
check — the default when no one asked for observability, keeping the
hot path free.
"""
from __future__ import annotations

from typing import Optional

from .recorder import FLIGHT_DIR_ENV, FlightRecorder
from .registry import (DEFAULT_BUCKETS, Counter, Gauge, Histogram, Registry,
                       flatten_numeric, parse_prometheus_text)
from .trace import NOOP_SPAN, NOOP_TRACE, Span, TraceContext, Tracer

__all__ = [
    "Observability",
    "Tracer", "Span", "TraceContext", "NOOP_SPAN", "NOOP_TRACE",
    "FlightRecorder", "FLIGHT_DIR_ENV",
    "Registry", "Counter", "Gauge", "Histogram", "DEFAULT_BUCKETS",
    "flatten_numeric", "parse_prometheus_text",
]


class Observability:
    """The tracer + flight recorder + registry bundle (module doc)."""

    def __init__(self, enabled: bool = True, trace_sample_rate: float = 1.0,
                 node: str = "n0", dump_dir=None,
                 trace_capacity: int = 8192, recorder_capacity: int = 2048,
                 registry: Optional[Registry] = None):
        self.enabled = bool(enabled)
        self.node = str(node)
        self.tracer = Tracer(enabled=self.enabled,
                             sample_rate=trace_sample_rate,
                             capacity=trace_capacity, node=self.node)
        self.recorder = FlightRecorder(capacity=recorder_capacity,
                                       dump_dir=dump_dir, node=self.node,
                                       enabled=self.enabled)
        self.registry = registry if registry is not None else Registry()

    _DISABLED: Optional["Observability"] = None

    @classmethod
    def disabled(cls) -> "Observability":
        """The shared all-off bundle (no sampling, no ring writes)."""
        if cls._DISABLED is None:
            cls._DISABLED = cls(enabled=False, trace_sample_rate=0.0)
        return cls._DISABLED
