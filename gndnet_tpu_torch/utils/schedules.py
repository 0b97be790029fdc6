"""Learning-rate schedules: counterparts of `gndnet_tpu.utils.schedules`.

`step_lr` is the live reference schedule (torch StepLR(step_size=15,
gamma=0.8), training.py:100), applied before every optimizer step as
optax's `scale_by_schedule` applies it.  The rest are the dormant
torchplus schedule library (reference torchplus/train/learning_schedules.py:
6-178): constant, manual stepping, exponential decay with burn-in and
cosine decay with warmup.

Each is a `Schedule`.  Called with an int32 count tensor it returns a
float32 0-dim tensor on the count's device with no host read (the train
step's program takes its rate this way); called with a Python int it
evaluates the same on a CPU count and returns that rate as a Python float
(logging, the CLIs), so a logged rate is the applied one.  Both compute
as the JAX package's schedule runs when traced under `jit` and compiled
by XLA:
float32 arithmetic with Python constants rounded to float32, a division by
a constant taken as a product with its float32 reciprocal, constant terms
and factors folded, a product and a sum contracted into one fma, and `pow`
and `cos` as float64 rounded to float32 (PyTorch's float32 `pow` and `cos`
are off by an ulp more often than XLA's CPU ones, which are not correctly
rounded either: where XLA's rounding errs, the two differ by an ulp).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch


class Schedule:
    """step -> learning rate: `fn(count)`, an int32 count tensor to a
    float32 0-dim tensor on its device; a Python step gives a float."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def __call__(self, step):
        if isinstance(step, torch.Tensor):
            return self.fn(step)
        return float(self.fn(torch.tensor(step, dtype=torch.int32)))


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """x rounded to a float32 0-dim tensor on `like`'s device (a fill, not
    a host-to-device copy)."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _recip(x: float) -> float:
    """The float32 reciprocal of a constant divisor."""
    return float(np.float32(1.0) / np.float32(x))


def _pow(base: float, exp: torch.Tensor) -> torch.Tensor:
    """float32(base) ** exp, in float64 rounded to float32."""
    return torch.pow(_f32(base, exp).double(), exp.double()).float()


def step_lr(base_lr: float, step_size_epochs: int, gamma: float,
            steps_per_epoch: int) -> Schedule:
    """lr = base * gamma ** (epoch // step_size), the epoch derived from
    the number of optimizer steps taken before this one."""
    spe = max(steps_per_epoch, 1)

    def rate(step: torch.Tensor) -> torch.Tensor:
        k = torch.div(torch.div(step, spe, rounding_mode="floor"),
                      step_size_epochs, rounding_mode="floor")
        return _f32(base_lr, step) * _pow(gamma, k)
    return Schedule(rate)


def constant_lr(base_lr: float) -> Schedule:
    return Schedule(lambda step: _f32(base_lr, step))


def manual_stepping(boundaries: Sequence[int],
                    rates: Sequence[float]) -> Schedule:
    """Piecewise-constant rates switching at step `boundaries` (torchplus
    ManualStepping: len(rates) == len(boundaries) + 1)."""
    if len(rates) != len(boundaries) + 1:
        raise ValueError("need len(rates) == len(boundaries) + 1")
    rates = np.asarray(rates, np.float32)

    def rate(step: torch.Tensor) -> torch.Tensor:
        idx = sum((step >= b).int() for b in boundaries)
        lr = _f32(float(rates[0]), step)
        for i in range(1, len(rates)):
            lr = torch.where(idx == i, float(rates[i]), lr)
        return lr
    return Schedule(rate)


def exponential_decay_with_burnin(base_lr: float, decay_steps: int,
                                  decay_factor: float,
                                  burnin_learning_rate: float = 0.0,
                                  burnin_steps: int = 0,
                                  staircase: bool = True) -> Schedule:
    """torchplus ExponentialDecayWithBurnin: `burnin_learning_rate` for
    `burnin_steps`, then base * decay_factor ** (step / decay_steps),
    floored when `staircase`."""

    def rate(step: torch.Tensor) -> torch.Tensor:
        exp = step.float() * _f32(_recip(decay_steps), step)
        if staircase:
            exp = torch.floor(exp)
        post = _f32(base_lr, step) * _pow(decay_factor, exp)
        if not burnin_steps:
            return post
        return torch.where(step < burnin_steps,
                           _f32(burnin_learning_rate, step), post)
    return Schedule(rate)


def cosine_decay_with_warmup(base_lr: float, total_steps: int,
                             warmup_learning_rate: float = 0.0,
                             warmup_steps: int = 0,
                             hold_base_rate_steps: int = 0) -> Schedule:
    """torchplus CosineDecayWithWarmup: linear warmup, an optional hold at
    the base rate, then cosine decay to zero."""
    f32 = np.float32
    held = warmup_steps + hold_base_rate_steps
    span = max(total_steps - held, 1)
    slope = (base_lr - warmup_learning_rate) / max(warmup_steps, 1)

    def rate(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        past = torch.clamp(s - _f32(held, s), min=0.0)
        frac = past * _f32(float(f32(math.pi) * f32(_recip(span))), s)
        cos = (1.0 + torch.cos(frac.double()).float()) * _f32(0.5 * base_lr,
                                                             s)
        lr = torch.where(s < held, _f32(base_lr, s), cos)
        if warmup_steps > 0:
            # XLA contracts the product and the sum into one fma
            warm = (s.double() * _f32(slope, s).double()
                    + _f32(warmup_learning_rate, s).double()).float()
            lr = torch.where(s < warmup_steps, warm, lr)
        return lr
    return Schedule(rate)
