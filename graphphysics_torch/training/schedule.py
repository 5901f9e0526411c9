"""Learning-rate schedule (counterpart of
``graphphysics_tpu/training/schedule.py``), the reference's
``CosineWarmupScheduler``:

    factor(step) = max(0.5*(1+cos(pi*(step+1)/max_iters)) * warmup_scale, min_lr_factor)

with ``warmup_scale = min(1, (step+1)/warmup)``: the cosine is multiplied
by the linear warmup, not replaced by it. Steps past ``max_iters`` keep the
last factor instead of ramping back up."""

from __future__ import annotations

import math
from typing import Callable


def cosine_warmup_schedule(
    learning_rate: float,
    warmup: int,
    max_iters: int,
    min_lr_factor: float = 0.001,
) -> Callable[[int], float]:
    """``schedule(step) -> learning rate`` for optimizer step ``step``
    (0 for the first update)."""

    def schedule(step: int) -> float:
        epoch = min(step + 1.0, float(max_iters))
        lr_factor = 0.5 * (1.0 + math.cos(math.pi * epoch / max_iters))
        warm = epoch / max(warmup, 1) if epoch <= warmup else 1.0
        return learning_rate * max(lr_factor * warm, min_lr_factor)

    return schedule
