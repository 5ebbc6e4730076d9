"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: ``None``
means ``"cuda"``, and a CUDA device raises when CUDA is absent — there is no
silent fall back to the CPU.  TF32 is switched off so float32 products on
Hopper stay float32 (the parity tests hold the port to the JAX reference's
float32 arithmetic).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``torch.device`` for ``device`` (default ``"cuda"``); raises
    ``RuntimeError`` if a CUDA device is asked for and CUDA is absent."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def same_device(a: DeviceLike, b: DeviceLike) -> bool:
    """Whether ``a`` and ``b`` name one device (``None`` is ``"cuda"``; a
    CUDA device without an index is the current one)."""

    def key(d):
        d = torch.device("cuda" if d is None else d)
        if d.type == "cuda" and d.index is None:
            return d.type, (torch.cuda.current_device()
                            if torch.cuda.is_available() else 0)
        return d.type, d.index

    return key(a) == key(b)
