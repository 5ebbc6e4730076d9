"""Elastic scaling: reshard a checkpoint onto a different mesh.

Checkpoints are mesh-agnostic (unsharded arrays + structure manifest), so
scaling from N to M chips is: build the new mesh, resolve shardings from the
same logical-axis rules, and lay each restored leaf out on it as a
``torch.distributed.tensor.DTensor``.  The logical rules make this a pure
re-layout — no model or optimizer surgery.

``plan_reshard`` additionally reports the per-device byte movement the
re-layout implies (useful to budget the scale-up pause); serving's elastic
restore (:func:`repro_torch.serve.snapshot.plan_elastic_restore`) reports its
budget through the same :func:`movement_plan` schema.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.distributed.sharding import LogicalAxisRules, tree_shardings
from repro_torch.launch.mesh import chips_in
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.utils import tree


def reshard_restore(
    ckpt: CheckpointManager,
    like,
    logical_tree,
    new_mesh,
    rules: Optional[LogicalAxisRules] = None,
    step: Optional[int] = None,
):
    """Restore a checkpoint onto ``new_mesh`` (different size/topology):
    ``like``'s structure, each leaf a DTensor with the placements its
    logical axes resolve to (the divisibility fallback on ``like``'s
    shapes)."""
    shardings = tree_shardings(new_mesh, logical_tree, like, rules)
    restored = ckpt.restore(like, step=step)
    return tree.map_leaves(lambda s, x: s.apply(x), shardings, restored)


def movement_plan(total_state_bytes: int, old_chips: int, new_chips: int,
                  est_transfer_bytes: Optional[int] = None) -> Dict[str, Any]:
    """The reshard-plan dict shape shared by every elastic transition —
    training checkpoints (:func:`plan_reshard`) and serving snapshots
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


def plan_reshard(like, logical_tree, old_mesh, new_mesh,
                 rules_old=None, rules_new=None) -> Dict[str, Any]:
    """Byte-movement estimate for an elastic transition (the worst case of
    :func:`movement_plan`, which the rules do not change; they are taken
    for the JAX package's signature)."""
    total_bytes = sum(x.numel() * x.element_size() for x in tree.leaves(like))
    return movement_plan(total_bytes, chips_in(old_mesh), chips_in(new_mesh))
