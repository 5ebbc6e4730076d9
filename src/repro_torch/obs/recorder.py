"""Flight recorder: a fixed-size ring of structured events, JSONL dumps.

The serving cluster's "what just happened?" black box.  Components call
:meth:`FlightRecorder.record` with a *kind* (``admission_reject``,
``watchdog_abort``, ``backend_fallback``, ``fence_rejection``,
``heartbeat_lapse``, ``promotion``, ``tail_resync``, ``fault_fired``, …)
plus free-form fields; events land in a bounded ring stamped with a
monotonic sequence number, a monotonic-clock time and a wall-clock time,
so the retained window is always a causally ordered, replayable timeline.

:meth:`trigger` is the auto-dump hook: the fault injector fires it at
every armed fault site, the coordinator on failover, and the serving loop
on degradation transitions (watchdog abort, backend-ladder move).  When a
``dump_dir`` is configured — explicitly or via the ``REPRO_FLIGHT_DIR``
environment variable (CI sets it so the 8-device matrix can upload dumps
as failure artifacts) — each trigger writes the full ring as a JSONL file
``flight-<node>-<n>.jsonl``; without one, the trigger is just another
ring event and tests read :meth:`events` / call :meth:`dump` directly.

Recording is lock-cheap: one ``itertools.count`` tick plus a
``deque.append`` (both atomic under the GIL), and a disabled recorder
(``enabled=False``) returns after a single attribute check.
"""
from __future__ import annotations

import itertools
import json
import os
import time
from collections import deque
from pathlib import Path
from typing import Any, Dict, List, Optional

__all__ = ["FlightRecorder"]

#: environment variable naming a default dump directory (CI artifacts)
FLIGHT_DIR_ENV = "REPRO_FLIGHT_DIR"


class FlightRecorder:
    """Bounded ring of structured events with triggered JSONL dumps."""

    def __init__(self, capacity: int = 2048, dump_dir=None, node: str = "n0",
                 enabled: bool = True):
        self.enabled = bool(enabled)
        self.node = str(node)
        self._events: "deque[Dict[str, Any]]" = deque(maxlen=int(capacity))
        self._seq = itertools.count(1)
        self._dump_seq = itertools.count(1)
        if dump_dir is None:
            dump_dir = os.environ.get(FLIGHT_DIR_ENV) or None
        self.dump_dir: Optional[Path] = (
            None if dump_dir is None else Path(dump_dir))
        #: paths of every dump written (tests assert on these)
        self.dumps: List[Path] = []
        self.recorded = 0
        self.triggers = 0

    # -- recording ------------------------------------------------------------
    def record(self, kind: str, **fields) -> None:
        """Append one event to the ring (cheap; safe from any thread)."""
        if not self.enabled:
            return
        ev = {"seq": next(self._seq), "t": time.monotonic(),
              "wall": time.time(), "node": self.node, "kind": kind}
        ev.update(fields)
        self._events.append(ev)
        self.recorded += 1

    def trigger(self, reason: str, **fields) -> Optional[Path]:
        """Record a ``dump_trigger`` event and — when a dump directory is
        configured — persist the whole ring as JSONL.  Returns the dump
        path (None when no directory is set or the recorder is off)."""
        if not self.enabled:
            return None
        self.triggers += 1
        self.record("dump_trigger", reason=reason, **fields)
        if self.dump_dir is None:
            return None
        try:
            return self.dump()
        except OSError:  # a full/readonly disk must never fault the loop
            return None

    # -- export ---------------------------------------------------------------
    def events(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        """Retained events in causal (seq) order, optionally one kind."""
        evs = sorted(list(self._events), key=lambda e: e["seq"])
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        return evs

    def dump(self, path=None) -> Path:
        """Write the retained ring as JSONL.  Default path:
        ``<dump_dir>/flight-<node>-<n>.jsonl``."""
        from repro_torch.utils.logging import json_default

        if path is None:
            if self.dump_dir is None:
                raise ValueError("no dump path and no dump_dir configured")
            self.dump_dir.mkdir(parents=True, exist_ok=True)
            path = self.dump_dir / (
                f"flight-{self.node}-{next(self._dump_seq):04d}.jsonl")
        path = Path(path)
        with open(path, "w") as fh:
            for ev in self.events():
                fh.write(json.dumps(ev, default=json_default) + "\n")
        self.dumps.append(path)
        return path

    @staticmethod
    def load_jsonl(path) -> List[Dict[str, Any]]:
        """Read a dump back (tests / offline analysis)."""
        with open(path) as fh:
            return [json.loads(line) for line in fh if line.strip()]
