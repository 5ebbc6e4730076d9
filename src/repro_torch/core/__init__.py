"""TAPER core: RPQ workload encoding (rpq), the TPSTry summary trie
(tpstry), the Visitor-Matrix extroversion field on the device (visitor),
vertex swapping (swap) and the invocation driver (taper)."""
from repro_torch.core.rpq import RPQ, parse_rpq, label, concat, union, star
from repro_torch.core.tpstry import TPSTry, TrieArrays
from repro_torch.core.visitor import ExtroversionResult, extroversion_field, vm_cell
from repro_torch.core.taper import Taper, TaperConfig, TaperReport

__all__ = [
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
