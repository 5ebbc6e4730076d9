from repro_torch.graphs.graph import LabelledGraph
from repro_torch.graphs.partition import hash_partition, metis_like_partition
from repro_torch.graphs.metrics import edge_cut, partition_balance, partition_sizes

__all__ = [
    "LabelledGraph",
    "hash_partition",
    "metis_like_partition",
    "edge_cut",
    "partition_balance",
    "partition_sizes",
]
