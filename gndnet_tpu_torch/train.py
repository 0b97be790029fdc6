"""Training: the train and eval steps and the epoch loop.

Counterpart of `gndnet_tpu.train` for single-device training: optionally
the on-device augmentation of the batch (`data.augmentation.
device_augment`), then `GroundEstimatorNet.fused(points, train=True)` on
the raw (B, N, F) batch (the affine canvas with K4/K5 forward and K6
backward, or the scatter canvas; a use_norm PFN on batch statistics
through the scatter frontend; SegNet with batch statistics) or, with
`use_pillar_path`, `pillarize_batch` and the reference-style `forward`
(any PFN depth), `losses.total_loss`, then SGD.  The 'sorted' impl has no
gradient and raises.  With loss scaling (`DynamicScale`) a step whose
gradients are not finite changes nothing but the scale and the step
count.

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

import numpy as np
import torch

from gndnet_tpu_torch import losses
from gndnet_tpu_torch._ext import resolve_device
from gndnet_tpu_torch.checkpoint import (CheckpointManager, checkpoint_dict,
                                         restore_checkpoint)
from gndnet_tpu_torch.config import GndNetConfig
from gndnet_tpu_torch.data import augmentation as aug
from gndnet_tpu_torch.data.provider import (GroundDataset, iterate_batches,
                                            prefetch_to_device)
from gndnet_tpu_torch.models.gndnet import GroundEstimatorNet
from gndnet_tpu_torch.models.segnet import no_tf32
from gndnet_tpu_torch.ops import pillarize as pz
from gndnet_tpu_torch.utils.logging import AverageMeter, setup_logger
from gndnet_tpu_torch.utils.schedules import step_lr
from gndnet_tpu_torch.weights import init_state_dict


AUGMENT_SEED = 0    # the JAX package keys augmentation on PRNGKey(0)


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


F32_TINY = float(np.finfo(np.float32).tiny)
F32_MAX = float(np.finfo(np.float32).max)


def _f32(x: float) -> float:
    return float(np.float32(x))


@dataclasses.dataclass
class DynamicScale:
    """Dynamic loss scaling with flax's `DynamicScale` rule and defaults
    (flax.training.dynamic_scale): the loss is multiplied by `scale`
    before the backward and the gradients divided by it in float32; after
    `growth_interval` finite steps in a row the scale grows by
    `growth_factor` (up to the float32 maximum), a step with a non-finite
    gradient backs it off by `backoff_factor` (down to `minimum_scale`),
    and either resets the run of finite steps.  The scale is kept a
    float32 value, as flax keeps it."""

    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000
    fin_steps: int = 0
    scale: float = 65536.0
    minimum_scale: float | None = F32_TINY

    def unscale_(self, params) -> bool:
        """Divide every .grad of `params` by the scale, in place; True when
        all of them are finite (one host sync)."""
        grads = [p.grad for p in params if p.grad is not None]
        finite = torch.ones((), dtype=torch.bool, device=grads[0].device)
        for g in grads:
            g.copy_(g.float() / self.scale)
            finite &= torch.isfinite(g).all()
        return bool(finite)

    def update(self, finite: bool) -> None:
        grow = self.fin_steps == self.growth_interval
        if not finite:
            scale = _f32(self.scale * self.backoff_factor)
            if self.minimum_scale is not None:
                scale = max(scale, self.minimum_scale)
            self.scale = scale
        elif grow:
            self.scale = _f32(min(self.scale * self.growth_factor, F32_MAX))
        self.fin_steps = 0 if grow or not finite else self.fin_steps + 1


@dataclasses.dataclass
class TrainState:
    """The model (parameters and batch-norm statistics), its optimizer
    (momentum buffers and the count of updates, which sets the schedule),
    the count of steps taken (which keys augmentation; it moves on a step
    that loss scaling skips, the update count does not) and the optional
    loss scale."""

    model: GroundEstimatorNet
    tx: Optimizer
    step: int = 0
    dynamic_scale: DynamicScale | None = None

    def state_dict(self) -> dict:
        return {**self.tx.state_dict(), "step": self.step,
                "dynamic_scale": (None if self.dynamic_scale is None
                                  else dataclasses.asdict(
                                      self.dynamic_scale))}

    def load_state_dict(self, sd: dict) -> None:
        self.tx.load_state_dict(sd)
        self.step = int(sd.get("step", sd["count"]))
        ds = sd.get("dynamic_scale")
        self.dynamic_scale = None if ds is None else DynamicScale(**ds)


def create_train_state(cfg: GndNetConfig, steps_per_epoch: int,
                       seed: int = 0, loss_scaling: bool = False,
                       state_dict: dict | None = None,
                       device=None) -> TrainState:
    """A fresh state on `device` (the card unless device='cpu'): weights
    from `state_dict` (the reference's names, e.g.
    `weights.state_dict_from_flax` of JAX variables) or from
    `weights.init_state_dict(cfg, seed)`.  `loss_scaling` adds a
    `DynamicScale` with flax's defaults."""
    model = GroundEstimatorNet(cfg, device=device)
    model.load_state_dict(init_state_dict(cfg, seed) if state_dict is None
                          else state_dict)
    return TrainState(model, make_optimizer(cfg, model.parameters(),
                                            steps_per_epoch),
                      dynamic_scale=DynamicScale() if loss_scaling else None)


def loss_fn(cfg: GndNetConfig) -> Callable:
    return lambda pred, labels: losses.total_loss(pred, labels, cfg.alpha,
                                                  cfg.beta)


def _as_batch(state: TrainState, points, labels):
    dev = state.model.device
    return (torch.as_tensor(points, dtype=torch.float32, device=dev),
            torch.as_tensor(labels, dtype=torch.float32, device=dev))


def _predict(model: GroundEstimatorNet, cfg: GndNetConfig, points,
             train: bool, use_pillar_path: bool, reference: bool = False):
    if not use_pillar_path:
        return model.fused(points, train=train, reference=reference)
    pb = pz.pillarize_batch(points, model.geom, cfg.max_points_voxel,
                            cfg.max_voxels)
    return model(pb.voxels, pb.coors, pb.num_points, pb.mask, train=train)


def make_train_step(cfg: GndNetConfig, augment: bool = False,
                    reference: bool = False,
                    use_pillar_path: bool = False) -> Callable:
    """(state, points (B, N, F), labels (B, ny, nx)) -> (state, loss): one
    forward with batch statistics, backward, and optimizer step; the state
    is updated in place.  The loss is returned on the device (no host sync
    without loss scaling).  At float32 / 'highest' on the card TF32 stays
    off through the backward too.  `reference=True` runs the plain version
    of every kernel stage.  `use_pillar_path=True` takes the
    reference-style path (`pillarize_batch`, then `forward`), which runs
    every configuration.

    `augment=True` first rotates and lifts the batch and its labels on the
    device (`data.augmentation`), drawn from a generator seeded from
    (AUGMENT_SEED, state.step): a fresh draw every step, the same draw for
    the same step (the JAX package's fold_in(PRNGKey(0), step)).

    With `state.dynamic_scale` the backward runs on the scaled loss and
    the gradients are unscaled; when one is not finite the step keeps the
    parameters, momentum, update count and batch-norm statistics (put back
    as they were before the forward), and the scale backs off.  The
    returned loss is then scaled loss / scale, as flax returns it."""
    total = loss_fn(cfg)

    def step(state: TrainState, points, labels):
        points, labels = _as_batch(state, points, labels)
        if augment:
            points, labels = aug.device_augment(
                points, labels, aug.augment_generator(
                    AUGMENT_SEED, state.step, points.device), cfg)
        model, ds = state.model, state.dynamic_scale
        # batch norm updates its running statistics during the forward
        saved = ({k: v.clone() for k, v in model.named_buffers()}
                 if ds is not None else None)
        with no_tf32(model.encoder_decoder.full_f32(model.device)):
            loss = total(_predict(model, cfg, points, True, use_pillar_path,
                                  reference), labels)
            state.tx.zero_grad()
            if ds is not None:
                scale = ds.scale
                loss = loss * scale
            loss.backward()
        state.step += 1
        if ds is not None:
            finite = ds.unscale_(state.tx.params)
            loss = loss / scale
            ds.update(finite)
            if not finite:
                with torch.no_grad():
                    for k, v in model.named_buffers():
                        v.copy_(saved[k])
                return state, loss.detach()
        state.tx.step()
        return state, loss.detach()

    return step


def make_eval_step(cfg: GndNetConfig,
                   use_pillar_path: bool = False) -> Callable:
    """(state, points, labels) -> loss with running statistics, no grad;
    `use_pillar_path` as in `make_train_step`."""
    total = loss_fn(cfg)

    def step(state: TrainState, points, labels):
        points, labels = _as_batch(state, points, labels)
        return total(_predict(state.model, cfg, points, False,
                              use_pillar_path), labels)

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
    validate, step the schedule and checkpoint (a `CheckpointManager` in
    workdir/checkpoints), with a best copy when the validation loss is the
    lowest so far.  `resume` restores weights, batch-norm statistics,
    momentum buffers, step counts, epoch and lowest loss from its latest
    step.

    `dp` / `sp` > 1 train over a (dp, sp) mesh of ranks: one process per
    rank (torchrun, or `parallel.multihost.spawn`), the process group
    initialized, every rank calling this with the same arguments.  Each
    rank takes its dp shard of every batch (`parallel.mesh`); sp > 1
    shards the pseudo-image height with halo exchange
    (`parallel.spatial`); gradients and batch statistics sync over the
    mesh and the state stays replicated.  Rank 0 alone writes the log file
    and the checkpoints, every rank resumes from them.  Validation runs
    the single-device eval step on the replicated state, on every rank.
    sp > 1 requires use_norm=False; batch_size must divide by dp.  Without
    a process group of dp * sp ranks it raises.  `device` is this rank's
    ('cuda': the card LOCAL_RANK).

    Returns {'train_loss': [...], 'valid_loss': [...], 'lowest_loss':
    float, 'state': TrainState}."""
    mesh, rank = None, 0
    if dp * sp > 1:
        from gndnet_tpu_torch.parallel import mesh as pmesh
        from gndnet_tpu_torch.parallel import multihost, spatial

        if cfg.batch_size % dp:
            raise ValueError(
                f"batch_size {cfg.batch_size} must divide by dp={dp}")
        if sp > 1 and cfg.use_norm:
            raise ValueError("spatial training requires use_norm=False")
        mesh = pmesh.make_mesh(dp, sp)
        rank = torch.distributed.get_rank()
        device = multihost.local_device(device)
    device = resolve_device(device)
    os.makedirs(workdir, exist_ok=True)
    logger = logger or setup_logger(
        "train" if rank == 0 else f"train_rank{rank}",
        os.path.join(workdir, "training.log") if rank == 0 else None)
    epochs = cfg.epochs if epochs is None else epochs
    if mesh is None:
        step_fn = make_train_step(cfg, augment=augment)
    else:
        logger.info("mesh: dp=%d x sp=%d over %d ranks", dp, sp, dp * sp)
        mesh_step = (spatial.make_spmd_train_step if sp > 1 else
                     pmesh.make_dp_train_step)(cfg, mesh, augment=augment)

        def step_fn(state, points, labels):
            return mesh_step(state, *pmesh.shard_batch(
                mesh, (points, labels), device))
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
    if mesh is not None:
        pmesh.replicate(mesh, state)

    ckpt_dir = os.path.join(workdir, "checkpoints")
    mgr = (CheckpointManager(ckpt_dir) if save_checkpoints and rank == 0
           else None)
    start_epoch, lowest_loss = 0, float("inf")
    if resume:
        # restore must not depend on whether this run saves (the
        # evaluate-only path resumes with save_checkpoints=False)
        restored = (mgr or CheckpointManager(ckpt_dir)).restore()
        if restored is not None:
            restored = restore_checkpoint(restored, state)
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
        if mgr is not None:
            mgr.save(epoch + 1, checkpoint_dict(state, epoch + 1,
                                                lowest_loss),
                     is_best=is_best)
        if mesh is not None and save_checkpoints:
            torch.distributed.barrier()   # every rank sees rank 0's save

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
