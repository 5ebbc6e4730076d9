"""Architecture registry: ``--arch <id>`` resolution, for the
configurations the port carries."""
from __future__ import annotations

from importlib import import_module
from typing import List

_ARCH_MODULES = {
    "gcn-cora": "repro_torch.configs.gcn_cora",
    "dlrm-rm2": "repro_torch.configs.dlrm_rm2",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def get_config(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {list_archs()}")
    return import_module(_ARCH_MODULES[arch]).CONFIG


def shapes_for(arch: str):
    return list(get_config(arch).shapes)
