"""Training: the fault-tolerant loop, checkpoints and the elastic schema.

:class:`Trainer` (``trainer.py``) drives a step function with periodic
atomic checkpoints (:class:`CheckpointManager`, whose atomic directory
publish the serving snapshotter shares), resume, failure injection, a
straggler watchdog and optional int8 gradient compression.
:mod:`repro_torch.train.elastic` restores a checkpoint onto a new device
mesh (``reshard_restore``), plans its byte movement (``plan_reshard``) and
holds the schema of elastic transitions (``movement_plan``).
"""
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["CheckpointManager", "Trainer", "TrainerConfig"]
