"""LR schedule, counterpart of ``uit_mobile_tpu/train/schedule.py``.

Cosine annealing from lr to ``final_scale * lr`` over ``total_steps``
updates, preceded by a linear warmup from 0 over ``warmup_iters``: optax's
``join_schedules([linear_schedule(0, lr, W), cosine_decay_schedule(lr, N,
alpha)], [W])``, as a plain function of the update count. The optimizer
reads it at the count *before* the update, so update 0 runs at lr 0 when
there is a warmup.
"""

from __future__ import annotations

import math
from typing import Callable


def cosine_with_warmup(base_lr: float, total_steps: int, warmup_iters: int | None = 1000,
                       final_scale: float = 0.01) -> Callable[[int], float]:
    decay_steps = max(total_steps, 1)

    def cosine(count: int) -> float:
        frac = min(count, decay_steps) / decay_steps
        cos = 0.5 * (1.0 + math.cos(math.pi * frac))
        return base_lr * ((1.0 - final_scale) * cos + final_scale)

    if not warmup_iters:
        return cosine

    def schedule(count: int) -> float:
        if count < warmup_iters:
            return base_lr * count / warmup_iters
        # optax's join_schedules hands the later schedule count - boundary
        return cosine(count - warmup_iters)

    return schedule
