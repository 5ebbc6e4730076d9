"""Distributed helpers: the logical-axis sharding rules (``sharding.py``,
over ``torch.distributed`` device meshes) and the gradient compressor."""
from repro_torch.distributed.compression import (compress_grads, init_residuals,
                                                 wire_bytes_saved)
from repro_torch.distributed.sharding import (MULTI_POD_RULES, SINGLE_POD_RULES,
                                              LogicalAxisRules, activation_sharding,
                                              constrain, logical_to_sharding, rules_for,
                                              tree_shardings)

__all__ = ["LogicalAxisRules", "MULTI_POD_RULES", "SINGLE_POD_RULES",
           "activation_sharding", "compress_grads", "constrain", "init_residuals",
           "logical_to_sharding", "rules_for", "tree_shardings", "wire_bytes_saved"]
