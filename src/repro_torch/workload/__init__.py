from repro_torch.workload.sketch import FrequencySketch
from repro_torch.workload.stream import (
    GraphMutationStream,
    WorkloadStream,
    periodic_frequencies,
    linear_drift,
)
from repro_torch.workload.executor import QueryExecutor, ipt_of_partition

__all__ = [
    "FrequencySketch",
    "GraphMutationStream",
    "WorkloadStream",
    "periodic_frequencies",
    "linear_drift",
    "QueryExecutor",
    "ipt_of_partition",
]
