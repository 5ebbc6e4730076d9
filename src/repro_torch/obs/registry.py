"""Unified metrics registry: counters, gauges, histograms, exporters.

One :class:`Registry` replaces the repo's scattered metric surfaces —
``serve/metrics.ServeMetrics``'s flat dict, ``utils/timing.Timer``'s
bespoke totals, and the ``pre["_halo_stats"]`` / ``pre["_shard_uploads"]``
side channels — behind three typed instruments plus a pull-based
**collector protocol**:

* :class:`Counter` — monotonic float (``inc``);
* :class:`Gauge` — last-write-wins float (``set``);
* :class:`Histogram` — fixed cumulative buckets + sum/count
  (``observe``), the shape Prometheus expects; per-SLO-class latency
  histograms are one metric name with a ``cls`` label per class;
* collectors — any component with a ``collect() -> dict`` method (the
  serving loop, executor, replication hub, followers, router,
  coordinator all implement it) registers under a prefix; the registry
  pulls them at export time, so components keep their cheap native
  counters and pay nothing per event.

Exporters: :meth:`Registry.to_prometheus_text` (the Prometheus text
exposition format — :func:`parse_prometheus_text` round-trips it, which
the test suite gates) and :meth:`Registry.export_jsonl` / ``snapshot()``
for dashboards that want one flat dict.

Instruments are lock-free on the hot path (float add / bucket increment
under the GIL); creation is locked and get-or-create, keyed on
``(name, sorted labels)``.
"""
from __future__ import annotations

import bisect
import json
import re
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry",
    "flatten_numeric", "parse_prometheus_text",
]

#: default latency buckets (seconds): micro-batch serving spans ~0.1ms-5s
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0)

LabelsKey = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Dict[str, str]) -> LabelsKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _sanitize(name: str) -> str:
    """Fold an arbitrary metric key into a legal Prometheus name."""
    name = _NAME_RE.sub("_", str(name))
    if not name or name[0].isdigit():
        name = "_" + name
    return name


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "labels", "value")
    kind = "counter"

    def __init__(self, name: str, labels: LabelsKey):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-write-wins value."""

    __slots__ = ("name", "labels", "value")
    kind = "gauge"

    def __init__(self, name: str, labels: LabelsKey):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Histogram:
    """Fixed-bucket histogram (cumulative on export, like Prometheus)."""

    __slots__ = ("name", "labels", "bounds", "counts", "sum", "count")
    kind = "histogram"

    def __init__(self, name: str, labels: LabelsKey,
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        self.name = name
        self.labels = labels
        self.bounds = tuple(float(b) for b in buckets)
        #: per-bucket (non-cumulative) counts; index len(bounds) = +Inf
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, x: float) -> None:
        x = float(x)
        self.counts[bisect.bisect_left(self.bounds, x)] += 1
        self.sum += x
        self.count += 1

    def cumulative(self) -> List[int]:
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile estimate (0 <= q <= 1)."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        acc = 0
        lo = 0.0
        for i, c in enumerate(self.counts):
            if acc + c >= target and c:
                hi = (self.bounds[i] if i < len(self.bounds)
                      else max(self.bounds[-1], self.sum / self.count))
                frac = (target - acc) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            acc += c
            if i < len(self.bounds):
                lo = self.bounds[i]
        return lo


class Registry:
    """Named, labelled instruments + pull collectors (module doc)."""

    def __init__(self, namespace: str = "repro"):
        self.namespace = str(namespace)
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, LabelsKey], Any] = {}
        #: prefix -> zero-arg callable returning a (possibly nested) dict;
        #: re-registering a prefix replaces the old collector (a promoted
        #: loop takes over its predecessor's slot)
        self._collectors: Dict[str, Callable[[], Dict[str, Any]]] = {}

    # -- instruments ----------------------------------------------------------
    def _get(self, cls, name: str, labels: Dict[str, str], **kw):
        key = (str(name), _labels_key(labels))
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(key[0], key[1], **kw)
                    self._metrics[key] = m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r}{dict(labels)!r} already registered as "
                f"{type(m).__name__}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str,
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, buckets=buckets)

    def metrics(self) -> List[Any]:
        with self._lock:
            return sorted(self._metrics.values(),
                          key=lambda m: (m.name, m.labels))

    # -- collectors -----------------------------------------------------------
    def register_collector(self, prefix: str,
                           fn: Callable[[], Dict[str, Any]]) -> None:
        """Register (or replace) the component collector at ``prefix``."""
        with self._lock:
            self._collectors[str(prefix)] = fn

    def unregister_collector(self, prefix: str) -> None:
        with self._lock:
            self._collectors.pop(str(prefix), None)

    def collected(self) -> Dict[str, float]:
        """Pull every collector; nested dicts flatten with ``_`` joins and
        non-numeric values are dropped (they belong in span attributes or
        the flight recorder, not in a numeric metrics plane)."""
        with self._lock:
            items = list(self._collectors.items())
        out: Dict[str, float] = {}
        for prefix, fn in items:
            try:
                d = fn()
            except Exception:  # a dying component must not kill export
                continue
            out.update(flatten_numeric(d, prefix=prefix))
        return out

    # -- export ---------------------------------------------------------------
    def snapshot(self) -> Dict[str, float]:
        """One flat dict: every instrument (histograms as
        ``_count``/``_sum``/``_p50``/``_p99``) plus every collected value."""
        out: Dict[str, float] = {}
        for m in self.metrics():
            suffix = "".join(f"_{k}_{v}" for k, v in m.labels)
            base = _sanitize(m.name + suffix)
            if m.kind == "histogram":
                out[base + "_count"] = m.count
                out[base + "_sum"] = m.sum
                out[base + "_p50"] = m.quantile(0.50)
                out[base + "_p99"] = m.quantile(0.99)
            else:
                out[base] = m.value
        out.update(self.collected())
        return out

    def to_prometheus_text(self, include_collected: bool = True) -> str:
        """The Prometheus text exposition format.  Instruments render with
        ``# TYPE`` headers; collected values render as untyped gauges."""
        lines: List[str] = []
        typed: Dict[str, str] = {}
        for m in self.metrics():
            name = _sanitize(m.name)
            if typed.get(name) is None:
                lines.append(f"# TYPE {name} {m.kind}")
                typed[name] = m.kind
            lab = _fmt_labels(m.labels)
            if m.kind == "histogram":
                cum = m.cumulative()
                for b, c in zip(m.bounds, cum):
                    lines.append(
                        f"{name}_bucket{_fmt_labels(m.labels, le=b)} {c}")
                lines.append(
                    f'{name}_bucket{_fmt_labels(m.labels, le="+Inf")} '
                    f"{cum[-1]}")
                lines.append(f"{name}_sum{lab} {_fmt_value(m.sum)}")
                lines.append(f"{name}_count{lab} {m.count}")
            else:
                lines.append(f"{name}{lab} {_fmt_value(m.value)}")
        if include_collected:
            for k, v in sorted(self.collected().items()):
                name = _sanitize(k)
                if typed.get(name) is None:
                    lines.append(f"# TYPE {name} gauge")
                    typed[name] = "gauge"
                lines.append(f"{name} {_fmt_value(v)}")
        return "\n".join(lines) + "\n"

    def export_jsonl(self, path) -> int:
        """Write ``snapshot()`` one ``{"metric":..., "value":...}`` JSON
        object per line; returns the number of lines."""
        from repro_torch.utils.logging import json_default

        snap = self.snapshot()
        with open(path, "w") as fh:
            for k in sorted(snap):
                fh.write(json.dumps({"metric": k, "value": snap[k]},
                                    default=json_default) + "\n")
        return len(snap)


# ---------------------------------------------------------------------------
# helpers + the parse side of the Prometheus round trip
# ---------------------------------------------------------------------------


def flatten_numeric(d: Dict[str, Any], prefix: str = "") -> Dict[str, float]:
    """Flatten a (possibly nested) stats dict to ``prefix_key`` -> float,
    keeping only int/float/bool values (bools export as 0/1)."""
    out: Dict[str, float] = {}
    for k, v in d.items():
        key = f"{prefix}_{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_numeric(v, prefix=key))
        elif isinstance(v, bool):
            out[_sanitize(key)] = float(v)
        elif isinstance(v, (int, float)):
            out[_sanitize(key)] = v
    return out


def _fmt_value(v: float) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _fmt_labels(labels: LabelsKey, le: Optional[Any] = None) -> str:
    parts = [f'{k}="{v}"' for k, v in labels]
    if le is not None:
        le_s = le if isinstance(le, str) else _fmt_value(le)
        parts.append(f'le="{le_s}"')
    return "{" + ",".join(parts) + "}" if parts else ""


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$")
_LABEL_RE = re.compile(r'(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>[^"]*)"')


def parse_prometheus_text(text: str) -> "Registry":
    """Parse Prometheus text exposition back into a fresh :class:`Registry`
    (typed instruments reconstructed from ``# TYPE`` headers; histogram
    buckets de-cumulated).  ``to_prometheus_text`` of the result is
    byte-identical to the input for registry-rendered text — the
    round-trip property the test suite gates."""
    reg = Registry()
    types: Dict[str, str] = {}
    hist: Dict[Tuple[str, LabelsKey], Dict[str, Any]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"unparseable sample line: {line!r}")
        name, labels_s, value = m.group("name", "labels", "value")
        labels = {lm.group("k"): lm.group("v")
                  for lm in _LABEL_RE.finditer(labels_s or "")}
        base, suffix = name, ""
        for sfx in ("_bucket", "_sum", "_count"):
            if name.endswith(sfx) and types.get(name[:-len(sfx)]) \
                    == "histogram":
                base, suffix = name[:-len(sfx)], sfx
                break
        kind = types.get(base, "gauge")
        if kind == "histogram":
            le = labels.pop("le", None)
            key = (base, _labels_key(labels))
            h = hist.setdefault(key, {"buckets": {}, "sum": 0.0, "count": 0})
            if suffix == "_bucket":
                h["buckets"][le] = float(value)
            elif suffix == "_sum":
                h["sum"] = float(value)
            elif suffix == "_count":
                h["count"] = int(float(value))
        elif kind == "counter":
            reg.counter(base, **labels).value = float(value)
        else:
            reg.gauge(base, **labels).set(float(value))
    for (base, lkey), h in hist.items():
        bounds = sorted(float(b) for b in h["buckets"] if b != "+Inf")
        hm = reg.histogram(base, buckets=tuple(bounds), **dict(lkey))
        prev = 0.0
        for i, b in enumerate(bounds):
            cum = h["buckets"][_fmt_value(b)]
            hm.counts[i] = int(cum - prev)
            prev = cum
        inf = h["buckets"].get("+Inf", prev)
        hm.counts[len(bounds)] = int(inf - prev)
        hm.sum = h["sum"]
        hm.count = h["count"]
    return reg
