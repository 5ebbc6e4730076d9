from repro_torch.kernels.segment_spmm.ops import PackedEdges, pack_edges, pack_weights

__all__ = ["PackedEdges", "pack_edges", "pack_weights"]
