"""Replication's share of the single-node serving loop: the epoch-fence
error and the commit-state payload.

The serving loop authorizes every durable write against a replication
hub's epoch fence when one is attached (``ServingLoop.attach_replication``;
unattached, the loop is the single-node loop bit for bit) and ships each
invocation commit's volatile state as a :func:`commit_payload`.  This
module holds those pieces: :class:`FencedWrite` (a write the fence
refused), :class:`JournalGap` (tail replay impossible: the journal was
compacted past a follower), :func:`commit_payload` and
:func:`adopt_commit_payload`.  The hub, its frames and ship channel, and
the follower replicas come with the cluster slice.
"""
from __future__ import annotations

import copy
from typing import Any, Dict

import numpy as np


class FencedWrite(RuntimeError):
    """A durable write was rejected by the epoch fence (stale epoch, or a
    partitioned primary whose write lease lapsed)."""

    def __init__(self, stale_epoch: int, current_epoch: int, what: str = "",
                 partitioned: bool = False):
        self.stale_epoch = int(stale_epoch)
        self.current_epoch = int(current_epoch)
        self.what = what
        self.partitioned = bool(partitioned)
        if partitioned:
            msg = (f"write lease lost (link partitioned) at epoch "
                   f"{stale_epoch}: {what or 'write'} rejected")
        else:
            msg = (f"stale epoch {stale_epoch} (cluster at {current_epoch}): "
                   f"{what or 'write'} rejected")
        super().__init__(msg)


class JournalGap(RuntimeError):
    """Tail replay is impossible: the journal was compacted past the
    follower's position — a full snapshot re-bootstrap is required."""


# ---------------------------------------------------------------------------
# commit-state shipping
# ---------------------------------------------------------------------------


def commit_payload(ot) -> Dict[str, Any]:
    """Copy everything an invocation commit touches that the WAL does not
    carry — the payload of a ``"commit"`` frame.  Captured on the primary
    right after ``commit_invocation`` (graph quiescent)."""
    pr = ot.placement_pr()
    return {
        "part": np.asarray(ot.part, np.int32).copy(),
        "dirty": np.asarray(ot._dirty, bool).copy(),
        "rng_state": copy.deepcopy(ot.taper._rng.bit_generator.state),
        "pr": None if pr is None else np.asarray(pr, np.float64).copy(),
        "invocations": int(ot.invocations),
        "tick": int(ot.tick),
        "last_invoke_tick": int(ot._last_invoke_tick),
        "freqs_at_invoke": dict(ot._freqs_at_invoke),
        "ipt_at_invoke": (None if ot._ipt_at_invoke is None
                          else float(ot._ipt_at_invoke)),
        "last_total_moves": (None if ot._last_total_moves is None
                             else int(ot._last_total_moves)),
        "version": int(ot.g.version),
        "n": int(ot.g.n),
    }


def adopt_commit_payload(ot, p: Dict[str, Any]) -> None:
    """Install a shipped commit payload on a replica's ``OnlineTaper``.
    Only valid at the commit's emission point in the stream — the replica's
    graph must match the payload's vertex count (the drain's total-order
    gating guarantees this; a covered stale commit is skipped there)."""
    if int(p["n"]) != int(ot.g.n):
        raise ValueError(
            f"commit payload for n={p['n']} vertices cannot apply to a "
            f"replica at n={ot.g.n} (apply the group stream first)")
    ot.part = np.asarray(p["part"], np.int32).copy()
    ot._dirty = np.asarray(p["dirty"], bool).copy()
    ot.taper._rng.bit_generator.state = copy.deepcopy(p["rng_state"])
    # the shipped Pr is the primary's post-commit placement prior; a stale
    # local field memo (a rejoining demoted primary has one) must not
    # shadow it, or arrival placements would diverge from the cluster
    ot.taper._field_memo = None
    ot.restore_placement_prior(p["pr"])
    ot.invocations = int(p["invocations"])
    ot.tick = int(p["tick"])
    ot._last_invoke_tick = int(p["last_invoke_tick"])
    ot._freqs_at_invoke = dict(p["freqs_at_invoke"])
    ot._ipt_at_invoke = (None if p["ipt_at_invoke"] is None
                         else float(p["ipt_at_invoke"]))
    ot._last_total_moves = (None if p["last_total_moves"] is None
                            else int(p["last_total_moves"]))
