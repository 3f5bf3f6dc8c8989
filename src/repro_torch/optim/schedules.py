"""LR schedules (the paper trains with cosine annealing), as host
functions of the step."""
from __future__ import annotations

import math


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1):
    def lr(step) -> float:
        step = float(step)
        if step < warmup:
            return base_lr * min(step / max(warmup, 1), 1.0)
        t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return base_lr * (min_ratio + (1 - min_ratio) * 0.5
                          * (1 + math.cos(math.pi * t)))
    return lr
