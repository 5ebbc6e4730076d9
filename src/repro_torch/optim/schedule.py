"""LR schedules."""
from __future__ import annotations

import math

import torch


def cosine_schedule(peak: float, warmup: int, total: int, floor_frac: float = 0.1):
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a cosine decay
    to ``floor_frac * peak`` at ``total``; ``lr(step)`` takes and returns a
    float32 tensor, in the JAX package's float32 arithmetic and order."""

    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = peak * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak * (floor_frac + (1 - floor_frac) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)

    return lr
