"""``vm_step.launches``: CUDA launches of the ``vm_step`` kernel a call (the
program's ``vm_step_launches_total``, counted where a launch is made, over
its ``field_evaluations_total``, ``repro_torch.obs.default_registry()``,
over the run's process).  Nothing where no launch was made (the CPU) or
the program keeps no such counters."""


def read(run):
    registry = getattr(__import__("repro_torch.obs").obs, "default_registry", None)
    snap = registry().snapshot() if registry else {}
    calls = snap.get("field_evaluations_total", 0)
    launches = snap.get("vm_step_launches_total", 0)
    if calls <= 0 or launches <= 0:
        return None
    return launches / calls
