"""Training: the train and eval steps and the epoch loop.

Counterpart of `gndnet_tpu.train` for single-device fused training:
`GroundEstimatorNet.fused(points, train=True)` on the raw (B, N, F) batch
(the affine canvas with K4/K5 forward and K6 backward, or the scatter
canvas; a use_norm PFN on batch statistics through the scatter frontend;
SegNet with batch statistics), `losses.total_loss`, then SGD.  The
'sorted' impl has no gradient and raises.

Optimizer parity: the JAX package's optax chain add_decayed_weights ->
trace(momentum) -> scale_by_schedule(-step_lr) is torch SGD(momentum,
weight_decay) on every parameter with the StepLR rate set before each
step, and the optional `clip_by_global_norm` comes first, without the
epsilon that `torch.nn.utils.clip_grad_norm_` adds.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable

import torch

from gndnet_tpu_torch import losses
from gndnet_tpu_torch._ext import resolve_device
from gndnet_tpu_torch.checkpoint import (latest_checkpoint,
                                         restore_checkpoint, save_checkpoint)
from gndnet_tpu_torch.config import GndNetConfig
from gndnet_tpu_torch.data.provider import (GroundDataset, iterate_batches,
                                            prefetch_to_device)
from gndnet_tpu_torch.models.gndnet import GroundEstimatorNet
from gndnet_tpu_torch.models.segnet import no_tf32
from gndnet_tpu_torch.utils.logging import AverageMeter, setup_logger
from gndnet_tpu_torch.utils.schedules import step_lr
from gndnet_tpu_torch.weights import init_state_dict


def clip_by_global_norm(params, max_norm: float) -> None:
    """optax.clip_by_global_norm on the .grad of `params`, in place: when
    the global norm g is at least max_norm, every gradient becomes
    (grad / g) * max_norm."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, (g / norm) * max_norm))


class Optimizer:
    """The JAX package's `make_optimizer` chain on `params`: optional
    global-norm clip, then SGD with momentum and weight decay at the
    StepLR rate of the number of steps taken so far."""

    def __init__(self, cfg: GndNetConfig, params, steps_per_epoch: int):
        self.params = list(params)
        self.sgd = torch.optim.SGD(self.params, lr=cfg.lr,
                                   momentum=cfg.momentum,
                                   weight_decay=cfg.weight_decay)
        self.schedule = step_lr(cfg.lr, cfg.lr_step_size, cfg.lr_gamma,
                                steps_per_epoch)
        self.clip = cfg.clip if cfg.use_grad_clip else None
        self.count = 0

    def zero_grad(self) -> None:
        self.sgd.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.clip is not None:
            clip_by_global_norm(self.params, self.clip)
        for group in self.sgd.param_groups:
            group["lr"] = self.schedule(self.count)
        self.sgd.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"sgd": self.sgd.state_dict(), "count": self.count}

    def load_state_dict(self, sd: dict) -> None:
        self.sgd.load_state_dict(sd["sgd"])
        self.count = int(sd["count"])


def make_optimizer(cfg: GndNetConfig, params,
                   steps_per_epoch: int) -> Optimizer:
    return Optimizer(cfg, params, steps_per_epoch)


@dataclasses.dataclass
class TrainState:
    """The model (parameters and batch-norm statistics) and its optimizer
    (momentum buffers and the step count that sets the schedule)."""

    model: GroundEstimatorNet
    tx: Optimizer

    @property
    def step(self) -> int:
        return self.tx.count


def create_train_state(cfg: GndNetConfig, steps_per_epoch: int,
                       seed: int = 0, loss_scaling: bool = False,
                       state_dict: dict | None = None,
                       device=None) -> TrainState:
    """A fresh state on `device` (the card unless device='cpu'): weights
    from `state_dict` (the reference's names, e.g.
    `weights.state_dict_from_flax` of JAX variables) or from
    `weights.init_state_dict(cfg, seed)`."""
    if loss_scaling:
        raise NotImplementedError(
            "loss scaling (the JAX package's DynamicScale) is ROADMAP.md "
            "queue 1, 'Loss scaling'")
    model = GroundEstimatorNet(cfg, device=device)
    model.load_state_dict(init_state_dict(cfg, seed) if state_dict is None
                          else state_dict)
    return TrainState(model, make_optimizer(cfg, model.parameters(),
                                            steps_per_epoch))


def loss_fn(cfg: GndNetConfig) -> Callable:
    return lambda pred, labels: losses.total_loss(pred, labels, cfg.alpha,
                                                  cfg.beta)


def _as_batch(state: TrainState, points, labels):
    dev = state.model.device
    return (torch.as_tensor(points, dtype=torch.float32, device=dev),
            torch.as_tensor(labels, dtype=torch.float32, device=dev))


def make_train_step(cfg: GndNetConfig, augment: bool = False,
                    reference: bool = False) -> Callable:
    """(state, points (B, N, F), labels (B, ny, nx)) -> (state, loss): one
    fused forward with batch statistics, backward, and optimizer step; the
    state is updated in place.  The loss is returned on the device (no
    host sync).  At float32 / 'highest' on the card TF32 stays off through
    the backward too.  `reference=True` runs the plain version of every
    kernel stage."""
    if augment:
        raise NotImplementedError(
            "on-device augmentation is ROADMAP.md queue 1, 'Augmentation'")
    total = loss_fn(cfg)

    def step(state: TrainState, points, labels):
        points, labels = _as_batch(state, points, labels)
        model = state.model
        with no_tf32(model.encoder_decoder.full_f32(model.device)):
            loss = total(model.fused(points, train=True,
                                     reference=reference), labels)
            state.tx.zero_grad()
            loss.backward()
        state.tx.step()
        return state, loss.detach()

    return step


def make_eval_step(cfg: GndNetConfig) -> Callable:
    """(state, points, labels) -> loss with running statistics, no grad."""
    total = loss_fn(cfg)

    def step(state: TrainState, points, labels):
        points, labels = _as_batch(state, points, labels)
        return total(state.model.fused(points), labels)

    return step


def _run_validation(valid_ds, cfg, eval_step, state, seed, epoch,
                    print_freq, logger) -> float:
    """One pass over the validation split (every frame: drop_last=False);
    returns the frame-weighted mean loss."""
    vmeter = AverageMeter()
    batches = prefetch_to_device(iterate_batches(
        valid_ds, cfg.batch_size, shuffle=True, drop_last=False,
        seed=seed + 999, epoch=epoch), state.model.device)
    for i, (points, labels) in enumerate(batches):
        vmeter.update(float(eval_step(state, points, labels)),
                      points.shape[0])
        if i % print_freq == 0:
            logger.debug("Test: [%d/%d]\tLoss %.4f (%.4f)",
                         i, max(len(valid_ds) // cfg.batch_size, 1),
                         vmeter.val, vmeter.avg)
    return vmeter.avg


def train_and_evaluate(cfg: GndNetConfig, workdir: str = ".",
                       epochs: int | None = None, resume: bool = False,
                       save_checkpoints: bool = True, print_freq: int = 100,
                       seed: int = 0, train_skip: int = 6,
                       valid_skip: int = 3, augment: bool = False,
                       dp: int = 1, sp: int = 1, logger=None,
                       device=None) -> dict:
    """The reference's main loop (training.py:284-305): per epoch, train,
    validate, step the schedule and checkpoint, with a best copy when the
    validation loss is the lowest so far.  `resume` restores weights,
    batch-norm statistics, momentum buffers, schedule step, epoch and
    lowest loss from workdir/checkpoints.  Returns {'train_loss': [...],
    'valid_loss': [...], 'lowest_loss': float, 'state': TrainState}."""
    if dp * sp > 1:
        raise NotImplementedError(
            "dp/sp > 1 (data and spatial parallel training) is ROADMAP.md "
            "queue 1, 'Multi-GPU (dp/sp)'")
    device = resolve_device(device)
    os.makedirs(workdir, exist_ok=True)
    logger = logger or setup_logger(
        "train", os.path.join(workdir, "training.log"))
    epochs = cfg.epochs if epochs is None else epochs
    step_fn = make_train_step(cfg, augment=augment)
    eval_step = make_eval_step(cfg)

    train_ds = GroundDataset(
        cfg.data_dir, "training", train_skip, cfg.input_features,
        max_memory=cfg.max_memory * 2**20, logger=logger)
    try:
        valid_ds = GroundDataset(
            cfg.data_dir, "validation", valid_skip, cfg.input_features,
            max_memory=cfg.max_memory * 2**20, logger=logger)
    except FileNotFoundError:
        logger.warning("no validation split; validating on training data")
        valid_ds = train_ds
    if len(train_ds) < cfg.batch_size:
        raise ValueError(
            f"training split has {len(train_ds)} frames < batch_size "
            f"{cfg.batch_size} (drop_last would yield zero batches); lower "
            f"batch_size or train_skip")
    steps_per_epoch = max(len(train_ds) // cfg.batch_size, 1)
    state = create_train_state(cfg, steps_per_epoch, seed, device=device)

    ckpt_dir = os.path.join(workdir, "checkpoints")
    start_epoch, lowest_loss = 0, float("inf")
    if resume and latest_checkpoint(ckpt_dir) is not None:
        restored = restore_checkpoint(latest_checkpoint(ckpt_dir), state)
        start_epoch = restored["epoch"]
        lowest_loss = restored["lowest_loss"]
        logger.info("resumed from epoch %d (lowest %.6f)", start_epoch,
                    lowest_loss)

    history = {"train_loss": [], "valid_loss": []}
    for epoch in range(start_epoch, epochs):
        batch_time, data_time, meter = (AverageMeter(), AverageMeter(),
                                        AverageMeter())
        start = time.time()
        batches = prefetch_to_device(iterate_batches(
            train_ds, cfg.batch_size, shuffle=True, drop_last=True,
            seed=seed, epoch=epoch), state.model.device)
        for i, (points, labels) in enumerate(batches):
            data_time.update(time.time() - start)
            state, loss = step_fn(state, points, labels)
            meter.update(float(loss), points.shape[0])
            batch_time.update(time.time() - start)
            start = time.time()
            if i % print_freq == 0:
                logger.debug(
                    "Epoch: [%d][%d/%d]\tTime %.3f (%.3f)\tData %.3f (%.3f)"
                    "\tLoss %.6f (%.6f)", epoch, i, steps_per_epoch,
                    batch_time.val, batch_time.avg, data_time.val,
                    data_time.avg, meter.val, meter.avg)
        history["train_loss"].append(meter.avg)

        vavg = _run_validation(valid_ds, cfg, eval_step, state, seed, epoch,
                               print_freq, logger)
        history["valid_loss"].append(vavg)
        logger.info("epoch %d: train %.6f valid %.6f", epoch, meter.avg,
                    vavg)
        is_best = vavg < lowest_loss
        lowest_loss = min(vavg, lowest_loss)
        if save_checkpoints:
            save_checkpoint(ckpt_dir, state, epoch + 1, lowest_loss,
                            is_best=is_best)

    if not history["valid_loss"]:
        # evaluate-only (epochs == 0) or a fully resumed run: one pass on
        # the restored or initial parameters
        vavg = _run_validation(valid_ds, cfg, eval_step, state, seed,
                               start_epoch, print_freq, logger)
        history["valid_loss"].append(vavg)
        lowest_loss = min(lowest_loss, vavg)
        logger.info("validation: %.6f", vavg)

    history["lowest_loss"] = lowest_loss
    history["state"] = state
    return history
