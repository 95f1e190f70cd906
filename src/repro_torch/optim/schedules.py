"""LR schedules: pure functions of the step (exact-region state)."""
from __future__ import annotations

import math

import torch


def cosine_with_warmup(
    peak_lr: float,
    warmup_steps: int,
    total_steps: int,
    final_fraction: float = 0.1,
):
    """Linear warmup then cosine decay to ``final_fraction · peak``; the
    schedule maps a step (int or tensor) to an f32 0-d tensor on the
    step's device, computed in f32 as the reference computes it."""

    def schedule(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        t = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        t = t.clamp(0.0, 1.0)
        cos = final_fraction + (1 - final_fraction) * 0.5 * (
            1 + torch.cos(math.pi * t)
        )
        return torch.where(step < warmup_steps, warm, peak_lr * cos)

    return schedule
