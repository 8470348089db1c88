"""Learning-rate schedules, ported from ``repro.optim.schedules``: functions
of the int step tensor, all arithmetic in f32 as in the reference."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    def f(step: torch.Tensor) -> torch.Tensor:
        return torch.full((), lr, dtype=torch.float32, device=step.device)

    return f


def warmup_linear(lr: float, warmup: int, total: int, floor: float = 0.0):
    def f(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        w = torch.clamp(step / max(warmup, 1), max=1.0)
        decay = torch.clamp((total - step) / max(total - warmup, 1),
                            min=floor / max(lr, 1e-30))
        return lr * w * torch.clamp(decay, max=1.0)

    return f


def warmup_cosine(lr: float, warmup: int, total: int, floor: float = 0.0):
    def f(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        w = torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        rel = floor / max(lr, 1e-30)
        cos = rel + (1 - rel) * 0.5 * (1 + torch.cos(math.pi * t))
        return lr * w * cos

    return f
