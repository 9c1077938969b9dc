"""Learning-rate schedules (plain functions of the step counter).

The port's counterpart of ``repro/training/schedule.py``.  Each schedule
takes the step as an int and returns the rate as a Python float holding a
float32 value, computed in float32 as the reference computes it.
"""
from __future__ import annotations

import numpy as np

__all__ = ["warmup_cosine", "constant"]


def constant(lr: float):
    return lambda step: float(np.float32(lr))


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def lr(step):
        step = np.float32(step)
        warm = np.float32(peak) * (step + np.float32(1.0)) / np.float32(max(warmup_steps, 1))
        t = np.clip((step - np.float32(warmup_steps))
                    / np.float32(max(total_steps - warmup_steps, 1)),
                    np.float32(0), np.float32(1))
        cos = np.float32(peak) * (np.float32(final_frac) + np.float32(1 - final_frac)
                                  * np.float32(0.5) * (np.float32(1) + np.cos(np.float32(np.pi) * t)))
        return float(warm if step < warmup_steps else cos)
    return lr
