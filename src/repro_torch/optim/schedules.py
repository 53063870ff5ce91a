"""LR schedules (warmup + cosine, the standard LM training recipe): each
maps the optimizer's int32 step count (a 0-d tensor) to an f32 0-d tensor
on its device."""
from __future__ import annotations

import math

import torch


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_fraction: float = 0.1):
    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_fraction + (1 - final_fraction)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return schedule


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)
