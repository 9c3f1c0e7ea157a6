"""Learning-rate schedules of the int32 step count, in f32 — the port of
``repro.optim.schedules``."""
from __future__ import annotations

import math

import torch


def constant(value: float):
    return lambda count: torch.tensor(value, dtype=torch.float32,
                                      device=count.device)


def cosine_decay(peak: float, total_steps: int, floor: float = 0.0):
    def fn(count):
        frac = torch.clamp(count.float() / total_steps, 0.0, 1.0)
        return floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * frac))
    return fn


def linear_warmup_cosine(peak: float, warmup: int, total_steps: int,
                         floor: float = 0.0):
    def fn(count):
        c = count.float()
        warm = peak * c / max(warmup, 1)
        frac = torch.clamp((c - warmup) / max(total_steps - warmup, 1),
                           0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * frac))
        return torch.where(c < warmup, warm, cos)
    return fn
