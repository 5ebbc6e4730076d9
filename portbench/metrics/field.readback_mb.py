"""``field.readback_mb``: bytes of the field's outputs read back to the host
a call, in MB (the program's ``field_readback_bytes_total`` over its
``field_evaluations_total``, ``repro_torch.obs.default_registry()``, over
the run's process: set-up, warm-up and window).  Nothing where the program
keeps no such counters."""


def read(run):
    registry = getattr(__import__("repro_torch.obs").obs, "default_registry", None)
    snap = registry().snapshot() if registry else {}
    calls = snap.get("field_evaluations_total", 0)
    if calls <= 0:
        return None
    return snap.get("field_readback_bytes_total", 0) / calls / 1e6
