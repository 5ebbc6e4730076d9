from repro_torch.configs.base import (
    ArchConfig,
    DLRMConfig,
    GNNConfig,
    LMConfig,
    MoEConfig,
    ShapeSpec,
    TaperSystemConfig,
)
from repro_torch.configs.registry import get_config, list_archs, shapes_for

__all__ = [
    "ArchConfig",
    "DLRMConfig",
    "GNNConfig",
    "LMConfig",
    "MoEConfig",
    "ShapeSpec",
    "TaperSystemConfig",
    "get_config",
    "list_archs",
    "shapes_for",
]
