from repro_torch.graphs.graph import AppliedMutation, LabelledGraph, MutationBatch
from repro_torch.graphs.partition import (
    hash_partition,
    metis_like_partition,
    fennel_stream_partition,
)
from repro_torch.graphs.metrics import edge_cut, partition_balance, partition_sizes
from repro_torch.graphs.sharded_packing import (
    ShardedVMPacking,
    bfs_shard_order,
    build_sharded_vm_packing,
    compute_shard_order,
    partition_shard_order,
)

__all__ = [
    "AppliedMutation",
    "LabelledGraph",
    "MutationBatch",
    "hash_partition",
    "metis_like_partition",
    "fennel_stream_partition",
    "edge_cut",
    "partition_balance",
    "partition_sizes",
    "ShardedVMPacking",
    "bfs_shard_order",
    "build_sharded_vm_packing",
    "compute_shard_order",
    "partition_shard_order",
]
