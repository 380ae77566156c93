"""Learning-rate schedules, in the port: pure functions of the int step.

The port's copy of ``repro.optim.schedules``.  ``step`` is a Python int or
an integer tensor (the optimizer's 0-d step counter, on its device); the
result is a 0-d f32 tensor on the step's device, computed in f32 as the
reference computes it.
"""
from __future__ import annotations

import math

import torch

__all__ = ["constant", "linear_warmup", "cosine_warmup"]


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def linear_warmup(lr: float, warmup: int):
    def fn(step):
        s = _f32(step)
        return torch.full_like(s, lr) * torch.clamp(s / max(warmup, 1), max=1.0)

    return fn


def cosine_warmup(lr: float, warmup: int, total: int, final_frac: float = 0.1):
    def fn(step):
        s = _f32(step)
        warm = torch.clamp(s / max(warmup, 1), max=1.0)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        # cos of the f32 angle, correctly rounded to f32 (torch's f32 cos is
        # an ulp off at some angles)
        c = torch.cos((math.pi * prog).to(torch.float64)).to(torch.float32)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + c)
        return torch.full_like(s, lr) * warm * cos

    return fn
