"""Distributed training helpers.

The JAX package's ``distributed`` also holds the logical-axis sharding rules
(``sharding.py``), which are built on JAX meshes and have no counterpart in
the port yet; the gradient compressor is here."""
from repro_torch.distributed.compression import (compress_grads, init_residuals,
                                                 wire_bytes_saved)

__all__ = ["compress_grads", "init_residuals", "wire_bytes_saved"]
