from repro_torch.kernels.segment_spmm.ops import (EdgeCSR, PackedEdges,
                                                  csr_from_edges,
                                                  csr_from_packing, csr_from_shard,
                                                  pack_edges,
                                                  pack_weights, segment_spmm,
                                                  segment_spmm_csr, vector_width)
from repro_torch.kernels.segment_spmm.ref import segment_spmm_reference

__all__ = ["EdgeCSR", "PackedEdges", "csr_from_edges", "csr_from_packing",
           "csr_from_shard",
           "pack_edges", "pack_weights", "segment_spmm", "segment_spmm_csr",
           "segment_spmm_reference", "vector_width"]
