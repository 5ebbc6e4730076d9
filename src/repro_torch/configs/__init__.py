from repro_torch.configs.base import (DLRMConfig, GNNConfig, LMConfig, MoEConfig,
                                      ShapeSpec)
from repro_torch.configs.registry import get_config, list_archs, shapes_for

__all__ = [
    "DLRMConfig",
    "GNNConfig",
    "LMConfig",
    "MoEConfig",
    "ShapeSpec",
    "get_config",
    "list_archs",
    "shapes_for",
]
