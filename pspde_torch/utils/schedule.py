"""Learning-rate schedules: ``lr`` of a solver is a number or a callable
step -> lr, as ``pspde``'s solvers take an optax schedule.

``torch.optim.Adam`` takes numbers only, so a solver builds its optimizer
at ``lr_at(lr, 0)`` and calls ``apply_lr`` before each optimizer step:
update i (from 0) runs at lr(i), as optax's ``scale_by_schedule`` counts.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Union

Lr = Union[float, Callable[[int], float]]


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0):
    """optax's ``cosine_decay_schedule``: step -> init_value * ((1 - alpha)
    * 0.5 (1 + cos(pi min(step, decay_steps) / decay_steps)) + alpha)."""
    if decay_steps <= 0:
        raise ValueError(f"decay_steps={decay_steps} must be positive")

    def schedule(step: int) -> float:
        frac = min(max(int(step), 0), decay_steps) / decay_steps
        cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
        return init_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def lr_at(lr: Lr, step: int) -> float:
    """The learning rate of update ``step``."""
    return float(lr(step)) if callable(lr) else float(lr)


def lr_text(lr: Lr) -> str:
    return "schedule" if callable(lr) else "%.2e" % lr


def apply_lr(optimizer, lrs: Sequence[Lr], step: int) -> None:
    """Set each parameter group's lr to its schedule's value at ``step``
    (``lrs``: one number or callable per group, in the groups' order)."""
    for group, lr in zip(optimizer.param_groups, lrs):
        if callable(lr):
            group["lr"] = lr_at(lr, step)
