"""Single-node graph-query serving on the port: the admission queue, the
ingest queue, the overlapped-invocation loop, its control loops, fault
sites, WAL and snapshots, and the synchronous engine facade.  The field
runs on the card unless the caller passes ``device="cpu"``.  Replication
hubs, the cluster and chaos scenarios come with the cluster slice."""
from repro_torch.obs import FlightRecorder, Observability, Registry, Tracer
from repro_torch.serve.control import (
    Breaker,
    BrownoutController,
    ControlConfig,
    HedgeController,
    WindowedQuantile,
    serve_pressure,
)
from repro_torch.serve.engine import GraphQueryEngine, RequestResult, ServeConfig
from repro_torch.serve.faults import (
    FaultInjector,
    FaultSpec,
    InjectedFault,
    corrupt_latest_snapshot,
)
from repro_torch.serve.ingest import IngestQueue, coalesce_mutations
from repro_torch.serve.loop import ServeLoopConfig, ServingLoop
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.queueing import Rejection, RequestQueue, ServeTicket
from repro_torch.serve.replication import FencedWrite, JournalGap
from repro_torch.serve.snapshot import (
    MutationJournal,
    RestoreResult,
    ServingSnapshotter,
    apply_journal_group,
    capture_serving_state,
    plan_elastic_restore,
    restore_serving_state,
)

__all__ = [
    "Breaker",
    "BrownoutController",
    "ControlConfig",
    "HedgeController",
    "WindowedQuantile",
    "serve_pressure",
    "FaultInjector",
    "FaultSpec",
    "FencedWrite",
    "FlightRecorder",
    "GraphQueryEngine",
    "Observability",
    "Registry",
    "Tracer",
    "IngestQueue",
    "InjectedFault",
    "JournalGap",
    "MutationJournal",
    "Rejection",
    "RequestQueue",
    "RequestResult",
    "RestoreResult",
    "ServeConfig",
    "ServeLoopConfig",
    "ServeMetrics",
    "ServeTicket",
    "ServingLoop",
    "ServingSnapshotter",
    "apply_journal_group",
    "capture_serving_state",
    "coalesce_mutations",
    "corrupt_latest_snapshot",
    "plan_elastic_restore",
    "restore_serving_state",
]
