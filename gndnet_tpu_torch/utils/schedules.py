"""Learning-rate schedule of the live training loop: counterpart of
`gndnet_tpu.utils.schedules.step_lr` (the reference's StepLR(step_size=15,
gamma=0.8), training.py:100), a `step -> lr` callable applied before every
optimizer step as optax's `scale_by_schedule` applies it."""

from __future__ import annotations


def step_lr(base_lr: float, step_size_epochs: int, gamma: float,
            steps_per_epoch: int):
    """lr = base * gamma ** (epoch // step_size), the epoch derived from
    the number of optimizer steps taken before this one."""
    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return base_lr * gamma ** (epoch // step_size_epochs)
    return schedule
