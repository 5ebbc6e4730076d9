"""Wrapper of the ``embedding_bag`` kernel: argument checks, the launch
count, and the choice between the kernel (CUDA tensors) and its plain
version (CPU tensors)."""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCH_LOCK
from repro_torch.kernels.embedding_bag.ref import embedding_bag_reference

COMBINERS = ("sum", "mean")


def _check(table: torch.Tensor, ids: torch.Tensor, combiner: str) -> None:
    if combiner not in COMBINERS:
        raise ValueError(f"embedding_bag: combiner must be one of {COMBINERS}, "
                         f"got {combiner!r}")
    if ids.device != table.device:
        raise ValueError(f"embedding_bag: ids are on {ids.device}, "
                         f"the table on {table.device}")
    if table.dtype != torch.float32 or table.dim() != 2:
        raise ValueError(f"embedding_bag: table must be 2-D float32, got "
                         f"{table.dim()}-D {table.dtype}")
    if ids.dtype != torch.int32 or ids.dim() != 2:
        raise ValueError(f"embedding_bag: ids must be 2-D int32, got "
                         f"{ids.dim()}-D {ids.dtype}")
    if not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError("embedding_bag: table and ids must be contiguous")
    if ids.shape[0] >= 2**31 or table.shape[1] >= 2**31:
        raise ValueError("embedding_bag: the kernel takes fewer than 2**31 "
                         "bags and columns")


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  combiner: str = "sum") -> torch.Tensor:
    """``(B, d)`` bag sums (or means, over all H slots) of ``table`` rows.

    ``table`` is ``(V, d)`` float32 and ``ids`` ``(B, H)`` int32 global row
    ids; an id outside ``[0, V)`` (for example a -1 pad) adds nothing.
    CUDA tensors go to the hand-written kernel (``csrc/embedding_bag.cu``),
    CPU tensors to the plain version.
    """
    _check(table, ids, combiner)
    if table.device.type == "cpu":
        return embedding_bag_reference(table, ids, combiner)
    if table.device.type != "cuda":
        raise ValueError(f"embedding_bag: no kernel for device {table.device}")
    from repro_torch.kernels.embedding_bag.kernel import embedding_bag_cuda

    out = embedding_bag_cuda(table, ids, combiner == "mean")
    with LAUNCH_LOCK:
        embedding_bag.launches += 1
    return out


#: kernel launches since the last reset (CPU calls do not count)
embedding_bag.launches = 0
