"""Architecture registry: ``--arch <id>`` resolution."""
from __future__ import annotations

from importlib import import_module
from typing import List

_ARCH_MODULES = {
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "qwen2.5-14b": "repro_torch.configs.qwen25_14b",
    "qwen3-4b": "repro_torch.configs.qwen3_4b",
    "gcn-cora": "repro_torch.configs.gcn_cora",
    "equiformer-v2": "repro_torch.configs.equiformer_v2",
    "gin-tu": "repro_torch.configs.gin_tu",
    "nequip": "repro_torch.configs.nequip",
    "dlrm-rm2": "repro_torch.configs.dlrm_rm2",
    "taper_paper": "repro_torch.configs.taper_paper",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def get_config(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {list_archs()}")
    return import_module(_ARCH_MODULES[arch]).CONFIG


def shapes_for(arch: str):
    cfg = get_config(arch)
    shapes = list(cfg.shapes)
    if cfg.family == "lm" and not cfg.supports_long_context:
        # long_500k needs a sub-quadratic attention path
        shapes = [s for s in shapes if s.name != "long_500k"]
    return shapes
