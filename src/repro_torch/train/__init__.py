"""Training-side helpers of the port.

Only the pieces the serving slice calls are here so far:
:func:`repro_torch.train.checkpoint.atomic_dir_publish` (the serving
snapshotter's atomic directory publish) and
:func:`repro_torch.train.elastic.movement_plan` (the elastic restore's
byte-movement schema).  The trainer, the checkpoint manager and the
reshard helpers come with the training slice.
"""
