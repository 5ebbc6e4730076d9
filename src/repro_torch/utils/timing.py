"""Wall-clock timing helpers (host-side; device work must be synchronised
first, e.g. by reading the result back to the host)."""
from __future__ import annotations

import time


class Timer:
    """Accumulating named timer.

    >>> t = Timer()
    >>> with t.section("foo"):
    ...     pass
    >>> t.totals["foo"] >= 0
    True
    """

    def __init__(self):
        self.totals: dict = {}
        self.counts: dict = {}

    def section(self, name: str):
        timer = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                dt = time.perf_counter() - self.t0
                timer.totals[name] = timer.totals.get(name, 0.0) + dt
                timer.counts[name] = timer.counts.get(name, 0) + 1
                return False

        return _Ctx()

    def summary(self) -> str:
        lines = []
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:<32} total={tot:8.3f}s  n={n:<5d} mean={tot / n:8.4f}s")
        return "\n".join(lines)
