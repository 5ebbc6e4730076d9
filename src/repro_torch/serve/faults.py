"""Fault injection for the serving loop.

A :class:`FaultInjector` is handed to ``ServingLoop`` via
``ServeLoopConfig.faults``; the loop calls :meth:`FaultInjector.fire` at
named *sites* on its hot paths and the injector either does nothing (the
site is unarmed) or raises / stalls per the armed :class:`FaultSpec`.  Sites
the loop exposes:

* ``invocation``   — start of the TAPER invocation thread body (kills the
  enhancement mid-run; drives the watchdog + backend-fallback ladder).
* ``shard_upload`` — inside ``_warm_devices`` before the sharded packing is
  pushed to devices (fails the device upload path).
* ``ingest_group`` — before a coalesced mutation group is applied (poisons
  the merged batch; exercises the per-member fallback).

Replication (``serve.replication``) adds transport and replica sites.  The
``ShipChannel`` fires transport sites per frame and interprets the armed
spec as a network behaviour instead of an exception: ``ship_drop`` loses
the frame, ``ship_delay`` holds it back a poll round (late, out-of-order
delivery), ``ship_reorder`` swaps it with the next frame.  Each may be
armed bare (every channel) or qualified per follower as
``"<site>:<name>"``; ``link_partition`` (checked via :meth:`armed`, not
consumed) blackholes a channel entirely.  Replica sites fault the follower
itself: ``replica_apply`` (before a shipped frame applies — ``raise``
crashes the replica, ``stall`` lags it) and ``replica_serve`` (before a
read executes — ``stall`` trips the router's deadline hedging, ``raise``
fails the read over to another replica).

Snapshot corruption has no hook site — it attacks data at rest — so it is a
plain function, :func:`corrupt_latest_snapshot`, flipping bytes in the
newest snapshot's ``arrays.npz`` to exercise the checksum-verified
fall-back-to-older-snapshot path in ``serve.snapshot``.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Type

from repro_torch.utils import get_logger

log = get_logger("serve.faults")

#: canonical site names (the loop fires these; tests arm them)
SITE_INVOCATION = "invocation"
SITE_SHARD_UPLOAD = "shard_upload"
SITE_INGEST_GROUP = "ingest_group"
#: replication transport sites (fired per frame by ``ShipChannel``; may be
#: qualified per follower as ``f"{site}:{name}"``)
SITE_SHIP_DROP = "ship_drop"
SITE_SHIP_DELAY = "ship_delay"
SITE_SHIP_REORDER = "ship_reorder"
#: persistent link state (checked, not consumed): blackholes a channel
SITE_LINK_PARTITION = "link_partition"
#: follower replica sites: crash/stall the apply path, fail/stall reads
SITE_REPLICA_APPLY = "replica_apply"
SITE_REPLICA_SERVE = "replica_serve"

#: every site the serving stack fires.  ``arm()`` validates against this
#: registry: a typo'd site would otherwise never fire and the test that
#: armed it would pass vacuously.
KNOWN_SITES = frozenset({
    SITE_INVOCATION, SITE_SHARD_UPLOAD, SITE_INGEST_GROUP,
    SITE_SHIP_DROP, SITE_SHIP_DELAY, SITE_SHIP_REORDER,
    SITE_LINK_PARTITION, SITE_REPLICA_APPLY, SITE_REPLICA_SERVE,
})


class InjectedFault(RuntimeError):
    """Raised by an armed ``mode="raise"`` fault site."""


@dataclass
class FaultSpec:
    """One armed fault.

    ``times`` bounds how often the site fires (``<= 0`` = every time —
    a *permanent* fault, e.g. for degraded-throughput floors).  ``mode``
    is ``"raise"`` (raise ``exc``) or ``"stall"`` (sleep ``delay_s``,
    e.g. to trip the invocation watchdog)."""

    mode: str = "raise"              # "raise" | "stall"
    times: int = 1
    delay_s: float = 0.0
    exc: Type[BaseException] = InjectedFault

    def __post_init__(self):
        if self.mode not in ("raise", "stall"):
            raise ValueError(f"unknown fault mode {self.mode!r}")


class FaultInjector:
    """Thread-safe registry of armed fault sites."""

    def __init__(self):
        self._lock = threading.Lock()
        self._armed: Dict[str, FaultSpec] = {}
        self.fired: Dict[str, int] = {}
        #: optional flight recorder (wired by the serving loop / cluster):
        #: every armed firing records a ``fault_fired`` event and triggers
        #: an auto-dump, so the ring around the fault is preserved
        self.recorder = None

    def arm(self, site: str, mode: str = "raise", times: int = 1,
            delay_s: float = 0.0,
            exc: Type[BaseException] = InjectedFault) -> None:
        """Arm ``site`` to fault on its next ``times`` firings.

        The site's bare name (before any ``:<follower>`` qualifier) must
        be in :data:`KNOWN_SITES` — a typo'd site never fires, so the
        test that armed it would pass vacuously."""
        base = site.split(":", 1)[0]
        if base not in KNOWN_SITES:
            raise ValueError(
                f"unknown fault site {site!r}; valid sites: "
                f"{', '.join(sorted(KNOWN_SITES))}")
        spec = FaultSpec(mode=mode, times=times, delay_s=delay_s, exc=exc)
        with self._lock:
            self._armed[site] = spec

    def disarm(self, site: Optional[str] = None) -> None:
        """Disarm one site, or every site when ``site`` is None."""
        with self._lock:
            if site is None:
                self._armed.clear()
            else:
                self._armed.pop(site, None)

    def fire(self, site: str) -> None:
        """Called by the loop at a fault site.  No-op unless armed."""
        with self._lock:
            spec = self._armed.get(site)
            if spec is None:
                return
            if spec.times > 0:
                spec.times -= 1
                if spec.times == 0:
                    del self._armed[site]
            self.fired[site] = self.fired.get(site, 0) + 1
        log.info("firing injected fault at %s (%s)", site, spec.mode)
        if self.recorder is not None:
            self.recorder.record("fault_fired", site=site, mode=spec.mode)
            self.recorder.trigger(f"fault:{site}")
        if spec.mode == "stall":
            time.sleep(spec.delay_s)
        else:
            raise spec.exc(f"injected fault at {site}")

    def armed(self, site: str) -> bool:
        """True while ``site`` is armed, without consuming a firing — for
        persistent *state* faults (``link_partition``) that gate behaviour
        for as long as they stay armed rather than firing N times."""
        with self._lock:
            return site in self._armed

    def fired_total(self) -> int:
        with self._lock:
            return sum(self.fired.values())


def corrupt_latest_snapshot(directory) -> Path:
    """Flip bytes in the middle of the newest snapshot's ``arrays.npz``
    (data-at-rest corruption).  Returns the damaged file's path; raises
    ``FileNotFoundError`` when no snapshot exists."""
    from repro_torch.serve.snapshot import SNAP_PREFIX

    directory = Path(directory)
    snaps = sorted(p for p in directory.glob(SNAP_PREFIX + "*")
                   if (p / "arrays.npz").exists())
    if not snaps:
        raise FileNotFoundError(f"no snapshot to corrupt under {directory}")
    target = snaps[-1] / "arrays.npz"
    blob = bytearray(target.read_bytes())
    mid = len(blob) // 2
    for off in range(mid, min(mid + 16, len(blob))):
        blob[off] ^= 0xFF
    target.write_bytes(bytes(blob))
    log.info("corrupted %s (%d bytes flipped mid-file)", target,
             min(16, len(blob) - mid))
    return target
