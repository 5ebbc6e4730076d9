"""``setup.edges_s``: host seconds of the program's
``LabelledGraph.from_undirected_edges`` in set-up (the sum of its
``graph_build_seconds{stage="edges"}``, ``repro_torch.obs.default_registry()``;
one build a run).  Nothing where the program keeps no such histogram."""


def read(run):
    registry = getattr(__import__("repro_torch.obs").obs, "default_registry", None)
    snap = registry().snapshot() if registry else {}
    if snap.get("graph_build_seconds_stage_edges_count", 0) <= 0:
        return None
    return snap["graph_build_seconds_stage_edges_sum"]
