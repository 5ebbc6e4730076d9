"""Wall-clock timing helpers (host-side; device work must be blocked first).

.. deprecated::
    ``Timer`` is now a thin shim over a private
    :class:`repro_torch.obs.registry.Registry` histogram per section — the
    unified metrics registry is the system of record for timing data.
    Existing benchmark callers keep the ``section``/``totals``/``counts``/
    ``summary`` surface unchanged; new code should take a ``Registry``
    (or an ``Observability`` bundle) and call
    ``registry.histogram("...").observe(dt)`` directly.
"""
from __future__ import annotations

import time


class Timer:
    """Accumulating named timer (deprecated shim; see module doc).

    >>> t = Timer()
    >>> with t.section("foo"):
    ...     pass
    >>> t.totals["foo"] >= 0
    True
    """

    def __init__(self, registry=None):
        from repro_torch.obs.registry import Registry

        self.registry = registry if registry is not None else Registry()

    def _hists(self):
        return [m for m in self.registry.metrics()
                if m.kind == "histogram" and m.name.startswith("timer_")]

    @property
    def totals(self) -> dict:
        return {m.name[len("timer_"):]: m.sum for m in self._hists()}

    @property
    def counts(self) -> dict:
        return {m.name[len("timer_"):]: m.count for m in self._hists()}

    def section(self, name: str):
        hist = self.registry.histogram(f"timer_{name}")

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                hist.observe(time.perf_counter() - self.t0)
                return False

        return _Ctx()

    def summary(self) -> str:
        lines = []
        counts = self.counts
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = counts[name]
            lines.append(f"{name:<32} total={tot:8.3f}s  n={n:<5d} mean={tot / n:8.4f}s")
        return "\n".join(lines)
