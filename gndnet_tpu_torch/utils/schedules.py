"""Learning-rate schedules: counterparts of `gndnet_tpu.utils.schedules`.

`step_lr` is the live reference schedule (torch StepLR(step_size=15,
gamma=0.8), training.py:100), applied before every optimizer step as
optax's `scale_by_schedule` applies it.  The rest are the dormant
torchplus schedule library (reference torchplus/train/learning_schedules.py:
6-178): constant, manual stepping, exponential decay with burn-in and
cosine decay with warmup.  Each is a `step -> lr` callable returning a
Python float computed in float32, as the JAX package's `jnp` versions
compute it.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np


def step_lr(base_lr: float, step_size_epochs: int, gamma: float,
            steps_per_epoch: int):
    """lr = base * gamma ** (epoch // step_size), the epoch derived from
    the number of optimizer steps taken before this one."""
    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return base_lr * gamma ** (epoch // step_size_epochs)
    return schedule


def constant_lr(base_lr: float):
    return lambda step: float(np.float32(base_lr))


def manual_stepping(boundaries: Sequence[int], rates: Sequence[float]):
    """Piecewise-constant rates switching at step `boundaries` (torchplus
    ManualStepping: len(rates) == len(boundaries) + 1)."""
    if len(rates) != len(boundaries) + 1:
        raise ValueError("need len(rates) == len(boundaries) + 1")
    rates = np.asarray(rates, np.float32)

    def schedule(step: int) -> float:
        return float(rates[sum(step >= b for b in boundaries)])
    return schedule


def exponential_decay_with_burnin(base_lr: float, decay_steps: int,
                                  decay_factor: float,
                                  burnin_learning_rate: float = 0.0,
                                  burnin_steps: int = 0,
                                  staircase: bool = True):
    """torchplus ExponentialDecayWithBurnin: `burnin_learning_rate` for
    `burnin_steps`, then base * decay_factor ** (step / decay_steps),
    floored when `staircase`."""
    f32 = np.float32

    def schedule(step: int) -> float:
        exp = f32(step) / f32(decay_steps)
        if staircase:
            exp = np.floor(exp)
        post = f32(base_lr) * f32(decay_factor) ** exp
        if burnin_steps and step < burnin_steps:
            return float(f32(burnin_learning_rate))
        return float(post)
    return schedule


def cosine_decay_with_warmup(base_lr: float, total_steps: int,
                             warmup_learning_rate: float = 0.0,
                             warmup_steps: int = 0,
                             hold_base_rate_steps: int = 0):
    """torchplus CosineDecayWithWarmup: linear warmup, an optional hold at
    the base rate, then cosine decay to zero."""
    f32 = np.float32

    def schedule(step: int) -> float:
        s = f32(step)
        held = warmup_steps + hold_base_rate_steps
        if warmup_steps > 0 and s < warmup_steps:
            slope = f32((base_lr - warmup_learning_rate) / warmup_steps)
            return float(slope * s + f32(warmup_learning_rate))
        if s < held:
            return float(f32(base_lr))
        frac = (f32(math.pi) * max(s - f32(held), f32(0.0))
                / f32(max(total_steps - held, 1)))
        return float(f32(0.5 * base_lr) * (f32(1.0) + np.cos(frac)))
    return schedule
