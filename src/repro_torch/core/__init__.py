"""TAPER core: RPQ workload encoding (rpq), the TPSTry summary trie
(tpstry), the Visitor-Matrix extroversion field on the device, whole or
per shard of a process group (visitor),
vertex swapping (swap), the invocation driver (taper) and the online
driver over a changing graph (online)."""
from repro_torch.core.rpq import RPQ, parse_rpq, label, concat, union, star
from repro_torch.core.tpstry import TPSTry, TrieArrays
from repro_torch.core.visitor import (FIELD_BACKENDS, HALO_EXCHANGES, ExtroversionResult,
                                      extroversion_field, vm_cell)
from repro_torch.core.taper import InvocationAborted, Taper, TaperConfig, TaperReport
from repro_torch.core.online import OnlinePolicy, OnlineStepReport, OnlineTaper

__all__ = [
    "FIELD_BACKENDS",
    "HALO_EXCHANGES",
    "InvocationAborted",
    "OnlinePolicy",
    "OnlineStepReport",
    "OnlineTaper",
    "RPQ",
    "parse_rpq",
    "label",
    "concat",
    "union",
    "star",
    "TPSTry",
    "TrieArrays",
    "ExtroversionResult",
    "extroversion_field",
    "vm_cell",
    "Taper",
    "TaperConfig",
    "TaperReport",
]
