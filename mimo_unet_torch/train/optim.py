"""Optimizer matching the reference training semantics.

Counterpart of ``mimo_unet_tpu/train/optim.py``: the reference's
``torch.optim.Adam(lr, weight_decay)`` (L2-in-gradient: ``g + w*p`` enters
the moments, not decoupled AdamW) with ``StepLR(step_size, gamma)`` stepped
per *epoch* (reference mimo/models/mimo_unet.py:185-201).  The train step
counts steps, so the schedule takes ``steps_per_epoch`` and floors.
"""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import torch


def step_lr_factor(step_size: int, gamma: float,
                   steps_per_epoch: int) -> Callable[[int], float]:
    """step -> gamma ** ((step // steps_per_epoch) // step_size), the
    multiplier of the base learning rate at that (0-based) step."""
    def factor(step: int) -> float:
        return gamma ** ((step // max(steps_per_epoch, 1)) // step_size)

    return factor


def adam_with_steplr(params: Iterable[torch.nn.Parameter], learning_rate: float,
                     weight_decay: float, scheduler_step_size: int,
                     scheduler_gamma: float, steps_per_epoch: int,
                     b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
                     ) -> Tuple[torch.optim.Adam, torch.optim.lr_scheduler.LambdaLR]:
    """(Adam, its per-step schedule): call ``scheduler.step()`` after each
    ``optimizer.step()``, so update k runs at lr * factor(k)."""
    opt = torch.optim.Adam(params, lr=learning_rate, betas=(b1, b2), eps=eps,
                           weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, step_lr_factor(scheduler_step_size, scheduler_gamma,
                            steps_per_epoch))
    return opt, sched
