"""Training: the fault-tolerant loop, checkpoints and the elastic schema.

:class:`Trainer` (``trainer.py``) drives a step function with periodic
atomic checkpoints (:class:`CheckpointManager`, whose atomic directory
publish the serving snapshotter shares), resume, failure injection, a
straggler watchdog and optional int8 gradient compression.
:func:`repro_torch.train.elastic.movement_plan` is the byte-movement schema
of elastic transitions; resharding a checkpoint onto a new mesh is built on
JAX meshes in the JAX package and is not ported yet.
"""
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["CheckpointManager", "Trainer", "TrainerConfig"]
