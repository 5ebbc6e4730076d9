"""Elastic transitions: the byte-movement plan schema.

The JAX package's module also reshards model checkpoints onto a new mesh;
the port's comes with the training slice.  Serving's elastic restore
(:func:`repro_torch.serve.snapshot.plan_elastic_restore`) reports its
budget through :func:`movement_plan`, so operator tooling reads one schema.
"""
from __future__ import annotations

from typing import Any, Dict, Optional


def movement_plan(total_state_bytes: int, old_chips: int, new_chips: int,
                  est_transfer_bytes: Optional[int] = None) -> Dict[str, Any]:
    """The reshard-plan dict shape shared by every elastic transition —
    training checkpoints and serving snapshots
    (``repro_torch.serve.snapshot.plan_elastic_restore``) report
    byte-movement budgets through the same keys so operator tooling reads
    one schema."""
    return {
        "total_state_bytes": int(total_state_bytes),
        "old_chips": int(old_chips),
        "new_chips": int(new_chips),
        "bytes_per_new_chip": total_state_bytes / max(new_chips, 1),
        # default worst case: every new chip pulls its full shard
        "est_transfer_bytes": int(
            total_state_bytes if est_transfer_bytes is None
            else est_transfer_bytes),
    }
