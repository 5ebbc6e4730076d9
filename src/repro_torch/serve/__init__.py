"""Graph-query serving on the port: the admission queue, the ingest
queue, the overlapped-invocation loop, its control loops, fault sites, WAL
and snapshots, the synchronous engine facade, and the replicated cluster —
WAL-shipped followers, epoch fencing, failover, owner-routed reads — with
its chaos scenarios.  The field runs on the card unless the caller passes
``device="cpu"``; a cluster's followers live on its primary's device."""
from repro_torch.obs import FlightRecorder, Observability, Registry, Tracer
from repro_torch.serve.chaos import (
    ChaosHarness,
    ChaosReport,
    Scenario,
    run_scenario,
    scenario,
)
from repro_torch.serve.cluster import ClusterConfig, ClusterCoordinator, ClusterRouter
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
from repro_torch.serve.replication import (
    FencedWrite,
    FollowerReplica,
    Frame,
    JournalGap,
    ReplicationHub,
    ShipChannel,
)
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
    "ChaosHarness",
    "ChaosReport",
    "ClusterConfig",
    "ClusterCoordinator",
    "ClusterRouter",
    "ControlConfig",
    "HedgeController",
    "Scenario",
    "WindowedQuantile",
    "run_scenario",
    "scenario",
    "serve_pressure",
    "FaultInjector",
    "FaultSpec",
    "FencedWrite",
    "FlightRecorder",
    "FollowerReplica",
    "Frame",
    "GraphQueryEngine",
    "Observability",
    "Registry",
    "Tracer",
    "IngestQueue",
    "InjectedFault",
    "JournalGap",
    "MutationJournal",
    "Rejection",
    "ReplicationHub",
    "RequestQueue",
    "RequestResult",
    "RestoreResult",
    "ServeConfig",
    "ServeLoopConfig",
    "ServeMetrics",
    "ServeTicket",
    "ServingLoop",
    "ServingSnapshotter",
    "ShipChannel",
    "apply_journal_group",
    "capture_serving_state",
    "coalesce_mutations",
    "corrupt_latest_snapshot",
    "plan_elastic_restore",
    "restore_serving_state",
]
