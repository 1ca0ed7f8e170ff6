"""Linear learning-rate decay (``ircolor_tpu/train/schedule.py``).

Training epoch ``k`` (1-based) runs at ``base_lr · f(k)``:

    f(k) = 1.0                                    for k ≤ decay_start
    f(k) = 0.0                                    for k ≥ epochs
    f(k) = 1 − (k − decay_start)/(epochs − decay_start)   otherwise

As a per-step schedule: the update after ``count`` earlier updates runs at
``schedule(count)``, optax's convention.
"""

from __future__ import annotations

from typing import Callable


def linear_decay_factor(epoch_1based: int, decay_start: int, epochs: int) -> float:
    e = epoch_1based
    if e >= epochs:
        return 0.0
    if e <= decay_start:
        return 1.0
    frac = (e - decay_start) / max(1, epochs - decay_start)
    return min(max(1.0 - frac, 0.0), 1.0)


def make_lr_schedule(base_lr: float, steps_per_epoch: int, epochs: int,
                     decay_start: int) -> Callable[[int], float]:
    """Step count → LR, matching per-epoch LambdaLR stepping."""

    def schedule(count: int) -> float:
        epoch = count // max(1, steps_per_epoch) + 1
        return base_lr * linear_decay_factor(epoch, decay_start, epochs)

    return schedule
