"""Learning-rate / momentum schedules: ``step (int) -> value (float)``.

Port of ``mmdet3d_gaussian_tpu/core/schedules.py``: the mmcv cyclic
one-cycle policy (``configs/_base_/schedules/cyclic_40e.py``: cosine ramp
base -> base * r_up over ``step_ratio_up`` of the cycle, then cosine down to
base * r_down) and step decay.  Evaluated on the host in Python floats, so a
train step reads no device value to set its learning rate.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence


def _cosine_anneal(start: float, end: float, frac: float) -> float:
    return end + 0.5 * (start - end) * (1 + math.cos(math.pi * frac))


def cyclic_schedule(base: float, total_steps: int,
                    target_ratio=(10.0, 1e-4), cyclic_times: int = 1,
                    step_ratio_up: float = 0.4) -> Callable[[int], float]:
    """mmcv cyclic policy repeated ``cyclic_times`` over ``total_steps``."""
    r_up, r_down = target_ratio
    period = max(1, total_steps // cyclic_times)
    up_steps = int(period * step_ratio_up)

    def schedule(step: int) -> float:
        s = int(step) % period
        if s < up_steps:
            return _cosine_anneal(base, base * r_up, s / max(up_steps, 1))
        return _cosine_anneal(base * r_up, base * r_down,
                              (s - up_steps) / max(period - up_steps, 1))

    return schedule


def step_schedule(base: float, milestones: Sequence[int],
                  gamma: float = 0.1) -> Callable[[int], float]:
    """``base * gamma ** (number of milestones <= step)``."""
    def schedule(step: int) -> float:
        lr = base
        for m in milestones:
            if step >= m:
                lr *= gamma
        return lr

    return schedule
