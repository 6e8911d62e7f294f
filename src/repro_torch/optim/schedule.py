"""LR schedules (port of ``repro/optim/schedule.py``).  BERT pretraining
uses linear warmup + polynomial decay."""
from __future__ import annotations

import numpy as np


def warmup_poly_decay(step, *, base_lr: float, warmup_steps: int,
                      total_steps: int, power: float = 1.0,
                      end_lr: float = 0.0) -> float:
    """The learning rate at ``step`` (a host number), computed in float32
    as the reference computes it; returned as a Python float holding that
    float32 value."""
    f32 = np.float32
    step = f32(step)
    warm = f32(base_lr) * step / f32(max(warmup_steps, 1))
    frac = np.clip((step - f32(warmup_steps))
                   / f32(max(total_steps - warmup_steps, 1)),
                   f32(0.0), f32(1.0))
    decay = (f32(base_lr) - f32(end_lr)) * (f32(1.0) - frac) ** f32(power) \
        + f32(end_lr)
    return float(warm if step < warmup_steps else decay)
