"""Reduction of a ``torch.profiler`` trace of the window to what the
per-layer readers need.

The harness wraps the window in the span ``portbench.window``, each draw of a
partition in ``portbench.draw`` and each call into the program in
``portbench.field``.  Device operations (kernels, copies, memsets) are kept
with their name, kind and interval; a device operation belongs to the call
whose span holds its start (each call ends with the field's copies back, so
its work has ended before the next span opens).
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

WINDOW, DRAW, FIELD = "portbench.window", "portbench.draw", "portbench.field"
_DEVICE_KINDS = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset",
                 "gpu_user_annotation": "annotation"}
_NAME_LEN = 160
_TOP = 10          # entries of each breakdown list
_SCAN = 4000       # host operations looked back over to name an idle gap

Interval = Tuple[int, int]


@dataclass
class DeviceOp:
    name: str
    kind: str            # kernel | memcpy | memset
    start: int           # ns
    end: int


@dataclass
class Trace:
    window: Interval
    spans: Dict[str, List[Interval]]
    ops: List[DeviceOp]
    host_ops: List[Tuple[int, int, str]] = field(default_factory=list)

    def calls(self) -> int:
        return len(self.spans.get(FIELD, []))

    def in_span(self, op: DeviceOp, name: str) -> bool:
        spans = self.spans.get(name, [])
        i = bisect.bisect_right(spans, (op.start, float("inf"))) - 1
        return i >= 0 and spans[i][0] <= op.start <= spans[i][1]

    def busy_ns(self, ops: Sequence[DeviceOp]) -> int:
        """Length of the union of the ops' intervals inside the window."""
        return sum(b - a for a, b in self.busy_intervals(ops))

    def busy_intervals(self, ops: Sequence[DeviceOp]) -> List[Interval]:
        lo, hi = self.window
        merged: List[List[int]] = []
        for a, b in sorted((max(o.start, lo), min(o.end, hi)) for o in ops):
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def window_ns(self) -> int:
        return self.window[1] - self.window[0]

    def breakdown(self) -> Dict[str, List[List]]:
        """The device operations that took most time, and the idle gaps by
        the innermost host operation or span running at each gap's middle."""
        by_name: Dict[str, int] = {}
        for o in self.ops:
            by_name[o.name] = by_name.get(o.name, 0) + (o.end - o.start)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:_TOP]
        gaps: Dict[str, int] = {}
        busy = self.busy_intervals(self.ops)
        edges = [self.window[0]] + [x for iv in busy for x in iv] + [self.window[1]]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                what = self.host_at((a + b) // 2)
                gaps[what] = gaps.get(what, 0) + (b - a)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:_TOP]
        return {"device_ops": [[nm, t / 1e9] for nm, t in ops],
                "idle_gaps": [[nm, t / 1e9] for nm, t in idle]}

    def host_at(self, t: int) -> str:
        """The innermost host operation running at ``t`` (looking back over
        at most ``_SCAN`` operations), else the innermost harness span."""
        i = bisect.bisect_right(self.host_ops, (t, float("inf"), "")) - 1
        for j in range(i, max(i - _SCAN, -1), -1):
            a, b, name = self.host_ops[j]
            if a <= t <= b:
                return f"host: {name}"
        for name in (FIELD, DRAW, WINDOW):
            spans = self.spans.get(name, [])
            k = bisect.bisect_right(spans, (t, float("inf"))) - 1
            if k >= 0 and spans[k][0] <= t <= spans[k][1]:
                return f"host: {name} (no torch op)"
        return "host: outside the harness's spans"


def _times(ev) -> Interval:
    if hasattr(ev, "start_ns"):
        return int(ev.start_ns()), int(ev.end_ns())
    start = int(ev.start_us() * 1000)
    return start, start + int(ev.duration_us() * 1000)


def _kind(ev) -> Optional[str]:
    act = ev.activity_type() if hasattr(ev, "activity_type") else None
    if act is not None:
        return _DEVICE_KINDS.get(str(act))
    if str(ev.device_type()).endswith("CUDA"):
        name = ev.name()
        return "memcpy" if name.startswith("Memcpy") else (
            "memset" if name.startswith("Memset") else "kernel")
    return None


def from_profiler(prof) -> Trace:
    """The ``Trace`` of a finished ``torch.profiler.profile`` session."""
    results = getattr(prof.profiler, "kineto_results", None)
    events = results.events() if results is not None else []
    spans: Dict[str, List[Interval]] = {WINDOW: [], DRAW: [], FIELD: []}
    ops: List[DeviceOp] = []
    host: List[Tuple[int, int, str]] = []
    for ev in events:
        name = ev.name()
        start, end = _times(ev)
        kind = _kind(ev)
        if name in spans:
            # the host's span; the profiler also marks each span's range on
            # the device's timeline, which is not a call of its own
            if kind is None and str(ev.device_type()).endswith("CPU"):
                spans[name].append((start, end))
            continue
        if kind == "annotation":
            continue
        if kind is not None:
            ops.append(DeviceOp(name[:_NAME_LEN], kind, start, end))
        elif str(ev.device_type()).endswith("CPU"):
            host.append((start, end, name[:_NAME_LEN]))
    for lst in spans.values():
        lst.sort()
    if not spans[WINDOW]:
        raise RuntimeError("trace: the window's span is missing")
    host.sort()
    return Trace(window=spans[WINDOW][0], spans=spans, ops=ops, host_ops=host)
