"""Learning-rate schedules: ``lr`` of a solver is a number or a callable
step -> lr, as ``pspde``'s solvers take an optax schedule.

A solver builds its Adam (``adam``) at ``lr_at(lr, step)`` and calls
``apply_lr`` before each optimizer step: update i (from 0) runs at lr(i),
as optax's ``scale_by_schedule`` counts.  On CUDA each group's lr is a 0-d
device tensor and the optimizer is ``capturable``, so that a captured CUDA
graph of several steps takes the lrs written into its buffers before each
replay (``solvers/_chunk.py``), and eager steps run the same ops.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Union

import torch

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
    (``lrs``: one number or callable per group, in the groups' order); a
    group's lr tensor (CUDA) is written in place."""
    for group, lr in zip(optimizer.param_groups, lrs):
        if callable(lr):
            if torch.is_tensor(group["lr"]):
                group["lr"].fill_(lr_at(lr, step))
            else:
                group["lr"] = lr_at(lr, step)


def adam(groups: Sequence[tuple], step: int,
         device: torch.device) -> torch.optim.Adam:
    """``torch.optim.Adam`` over ``groups``, pairs (params, lr), each group
    at ``lr_at(lr, step)``.  On CUDA the optimizer is ``capturable`` and
    each group's lr a 0-d float32 tensor on the device (a CUDA graph
    captures the step, and every step, eager or replayed, runs the same
    ops); on the CPU the lrs are numbers, as torch's defaults take them."""
    cuda = torch.device(device).type == "cuda"
    param_groups = []
    for params, lr in groups:
        value = lr_at(lr, step)
        param_groups.append({"params": list(params), "lr": torch.full(
            (), value, dtype=torch.float32, device=device) if cuda
            else value})
    return torch.optim.Adam(param_groups, lr=lr_at(groups[0][1], step),
                            capturable=cuda)
