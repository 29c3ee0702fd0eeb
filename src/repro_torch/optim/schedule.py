"""Learning-rate schedules (pure functions of the step counter).

Counterpart of ``repro/optim/schedule.py``: the same float32 arithmetic,
on float32 tensors.
"""
from __future__ import annotations

import math

import torch


def cosine_warmup(base_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    """Linear warmup then cosine decay to ``min_ratio * base_lr``.

    The returned ``lr(step)`` takes an int or an integer tensor and gives a
    float32 scalar tensor on the step's device."""

    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = step / max(1.0, warmup_steps)
        prog = (step - warmup_steps) / max(1.0, total_steps - warmup_steps)
        prog = torch.clamp(prog, 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return base_lr * torch.where(step < warmup_steps, warm, cos)

    return lr
