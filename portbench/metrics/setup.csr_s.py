"""``setup.csr_s``: host seconds of the program's ``vm_csr`` builds in
set-up, its packing and row plan included (the sum of its
``graph_build_seconds{stage="csr"}``, ``repro_torch.obs.default_registry()``;
one build a run, a cache hit not counted).  Nothing where the program keeps
no such histogram."""


def read(run):
    registry = getattr(__import__("repro_torch.obs").obs, "default_registry", None)
    snap = registry().snapshot() if registry else {}
    if snap.get("graph_build_seconds_stage_csr_count", 0) <= 0:
        return None
    return snap["graph_build_seconds_stage_csr_sum"]
