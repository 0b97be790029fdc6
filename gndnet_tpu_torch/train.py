"""Training: the train and eval steps and the epoch loop.

Counterpart of `gndnet_tpu.train` for single-device training: optionally
the on-device augmentation of the batch (`data.augmentation.
apply_augment`), then `GroundEstimatorNet.fused(points, train=True)` on
the raw (B, N, F) batch (the affine canvas with K4/K5 forward and K6
backward, or the scatter canvas; a use_norm PFN on batch statistics
through the scatter frontend; SegNet with batch statistics) or, with
`use_pillar_path`, `pillarize_batch` and the reference-style `forward`
(any PFN depth), `losses.total_loss`, then the update.  The 'sorted' impl
has no gradient and raises.  With loss scaling (`DynamicScale`) a step
whose gradients are not finite changes nothing but the scale and the step
count.

As JAX's `jax.jit(step, donate_argnums=(0,))` runs the step as one device
program with zero host round trips, the port's step is a fixed sequence of
device operations that reads nothing back to the host: the update count,
the learning rate (`utils.schedules`' device forms), the loss scale, its
run of finite steps and the finite flag are device tensors, and a skipped
step keeps the state by `torch.where`, not by a host branch.  On a CUDA
state the train step, and the eval step, replay one CUDA graph per state
and input shape (`utils.graphs`); on the CPU, with `reference=True` or
with `eager=True` they run eagerly.

Optimizer parity: the JAX package's optax chain add_decayed_weights ->
trace(momentum) -> scale_by_schedule(-step_lr), with the optional
`clip_by_global_norm` first, without the epsilon that
`torch.nn.utils.clip_grad_norm_` adds.
"""

from __future__ import annotations

import os
import time
import weakref
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
from gndnet_tpu_torch.utils.graphs import GraphCache
from gndnet_tpu_torch.utils.logging import AverageMeter, setup_logger
from gndnet_tpu_torch.utils.profiling import span
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


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _split(flat: torch.Tensor, like) -> list:
    return [x.view_as(t) for x, t in
            zip(flat.split([t.numel() for t in like]), like)]


@torch.no_grad()
def select_(keep: torch.Tensor, dst: list, new: list) -> None:
    """dst[i] = new[i] where the device bool `keep` is true, else left as
    it is, in place: one `torch.where` per dtype over the concatenated
    tensors."""
    by_dtype: dict = {}
    for d, n in zip(dst, new):
        by_dtype.setdefault(d.dtype, []).append((d, n))
    for pairs in by_dtype.values():
        ds = [d for d, _ in pairs]
        out = torch.where(keep, _flat(n for _, n in pairs), _flat(ds))
        torch._foreach_copy_(ds, _split(out, ds))


class Optimizer:
    """The JAX package's `make_optimizer` chain on `params`: optional
    global-norm clip, then SGD with momentum and weight decay at the
    StepLR rate of the number of updates taken so far.

    The momentum buffers are zeros from the start, as optax's `trace`
    initialises them (so no step allocates and the first is no special
    case), and `count_t`, the number of updates, is an int32 on the
    parameters' device: a step reads nothing back to the host.  `count` and
    `lr` read it out (host reads: for logs and checkpoints, never inside a
    step).  `load_state_dict` copies into the existing tensors, so a CUDA
    graph captured on them computes from what was loaded."""

    def __init__(self, cfg: GndNetConfig, params, steps_per_epoch: int):
        self.params = list(params)
        # views of one flat buffer, which the update reads and writes whole
        self.flat_momentum = torch.zeros(
            sum(p.numel() for p in self.params), dtype=self.params[0].dtype,
            device=self.params[0].device)
        self.momentum = _split(self.flat_momentum, self.params)
        self.schedule = step_lr(cfg.lr, cfg.lr_step_size, cfg.lr_gamma,
                                steps_per_epoch)
        self.decay = cfg.momentum
        self.weight_decay = cfg.weight_decay
        self.clip = cfg.clip if cfg.use_grad_clip else None
        self.count_t = torch.zeros((), dtype=torch.int32,
                                   device=self.params[0].device)

    @property
    def count(self) -> int:
        return int(self.count_t)

    @property
    def lr(self) -> float:
        """The rate of the last update (of the first before any)."""
        return self.schedule(max(self.count - 1, 0))

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, finite: torch.Tensor | None = None) -> None:
        """One update from the .grad of `params` (a missing one is zeros,
        as `jax.grad` gives an unused parameter): g + wd * p, then m =
        momentum * m + g, then p + (-lr) * m, each a fused multiply-add as
        XLA compiles optax's chain (the product of two float32 values is
        exact in float64, so each float64 sum rounded to float32 is that
        fma), on the concatenated tensors.  With a device bool `finite`
        (loss scaling) the parameters, momentum and count take their new
        values only where it is true."""
        if self.clip is not None:
            clip_by_global_norm(self.params, self.clip)
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        # the constants rounded to float32, as the JAX package's chain
        # takes them
        wd, decay = (float(np.float32(x))
                     for x in (self.weight_decay, self.decay))
        old_p, old_m = _flat(self.params), self.flat_momentum
        p = old_p.double()
        g = (_flat(grads).double() + p * wd).float()
        m = (old_m.double() * decay + g.double()).float()
        new_p = (p + m.double()
                 * (-self.schedule(self.count_t)).double()).float()
        if finite is not None:
            m = torch.where(finite, m, old_m)
            new_p = torch.where(finite, new_p, old_p)
        old_m.copy_(m)
        torch._foreach_copy_(self.params, _split(new_p, self.params))
        self.count_t += 1 if finite is None else finite.to(torch.int32)

    def state_dict(self) -> dict:
        """torch SGD's layout (the CLIs' checkpoints): the momentum buffers
        by parameter index, the hyper-parameters with the last rate, and
        the count."""
        group = {"lr": self.lr, "momentum": self.decay, "dampening": 0,
                 "weight_decay": self.weight_decay, "nesterov": False,
                 "maximize": False, "foreach": None, "differentiable": False,
                 "fused": None, "params": list(range(len(self.params)))}
        return {"sgd": {"state": {i: {"momentum_buffer": m.clone()}
                                  for i, m in enumerate(self.momentum)},
                        "param_groups": [group]},
                "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Copy the momentum buffers (zeros where a checkpoint taken before
        any step has none) and the count in place."""
        state = sd["sgd"]["state"]
        for i, m in enumerate(self.momentum):
            buf = state.get(i, {}).get("momentum_buffer")
            if buf is None:
                m.zero_()
            else:
                m.copy_(buf)
        self.count_t.fill_(int(sd["count"]))


def make_optimizer(cfg: GndNetConfig, params,
                   steps_per_epoch: int) -> Optimizer:
    return Optimizer(cfg, params, steps_per_epoch)


F32_TINY = float(np.finfo(np.float32).tiny)
F32_MAX = float(np.finfo(np.float32).max)


class DynamicScale:
    """Dynamic loss scaling with flax's `DynamicScale` rule and defaults
    (flax.training.dynamic_scale): the loss is multiplied by the scale
    before the backward and the gradients divided by it in float32; after
    `growth_interval` finite steps in a row the scale grows by
    `growth_factor` (up to the float32 maximum), a step with a non-finite
    gradient backs it off by `backoff_factor` (down to `minimum_scale`),
    and either resets the run of finite steps.

    The scale (float32) and the run of finite steps (int32) are tensors on
    `device` (`scale_t`, `fin_steps_t`) and the rule runs there, with no
    host read; `scale` and `fin_steps` read and set them (host reads,
    outside a step; setting copies in place).  The other fields are
    Python numbers: a captured step keeps the values it was captured
    with."""

    def __init__(self, growth_factor: float = 2.0,
                 backoff_factor: float = 0.5, growth_interval: int = 2000,
                 fin_steps: int = 0, scale: float = 65536.0,
                 minimum_scale: float | None = F32_TINY, device="cpu"):
        self.growth_factor = growth_factor
        self.backoff_factor = backoff_factor
        self.growth_interval = growth_interval
        self.minimum_scale = minimum_scale
        self.scale_t = torch.full((), scale, dtype=torch.float32,
                                  device=device)
        self.fin_steps_t = torch.full((), fin_steps, dtype=torch.int32,
                                      device=device)

    @property
    def scale(self) -> float:
        return float(self.scale_t)

    @scale.setter
    def scale(self, value: float) -> None:
        self.scale_t.fill_(value)

    @property
    def fin_steps(self) -> int:
        return int(self.fin_steps_t)

    @fin_steps.setter
    def fin_steps(self, value: int) -> None:
        self.fin_steps_t.fill_(value)

    def unscale_(self, params) -> torch.Tensor:
        """Divide every .grad of `params` by the scale, in place; returns
        whether all of them are finite, as a device bool."""
        grads = [p.grad for p in params if p.grad is not None]
        torch._foreach_div_(grads, self.scale_t)
        return torch.isfinite(_flat(grads)).all()

    def update(self, finite: torch.Tensor) -> None:
        """flax's rule, on the device."""
        scale, fin = self.scale_t, self.fin_steps_t
        grow = fin == self.growth_interval
        fin_scale = torch.where(grow & finite, torch.clamp(
            scale * self.growth_factor, max=F32_MAX), scale)
        inf_scale = scale * self.backoff_factor
        if self.minimum_scale is not None:
            inf_scale = torch.clamp(inf_scale, min=self.minimum_scale)
        new_fin = torch.where(grow | ~finite, 0, fin + 1)
        scale.copy_(torch.where(finite, fin_scale, inf_scale))
        fin.copy_(new_fin)

    def state_dict(self) -> dict:
        """Plain numbers (read out of the device)."""
        return {"growth_factor": self.growth_factor,
                "backoff_factor": self.backoff_factor,
                "growth_interval": self.growth_interval,
                "fin_steps": self.fin_steps, "scale": self.scale,
                "minimum_scale": self.minimum_scale}

    def load_state_dict(self, sd: dict) -> None:
        self.growth_factor = sd["growth_factor"]
        self.backoff_factor = sd["backoff_factor"]
        self.growth_interval = sd["growth_interval"]
        self.minimum_scale = sd["minimum_scale"]
        self.scale, self.fin_steps = sd["scale"], sd["fin_steps"]


class TrainState:
    """The model (parameters and batch-norm statistics), its optimizer
    (momentum buffers and the count of updates, which sets the schedule),
    the count of steps taken (which keys augmentation; it moves on a step
    that loss scaling skips, the update count does not) and the optional
    loss scale.

    The step count is an int32 on the device (`step_t`, which the train
    step moves) with a host mirror, `step`, which every step moves once,
    captured or not: augmentation and checkpoints read the mirror.  Setting
    `step` sets both.  A CUDA graph holds the tensors of the state it was
    captured on, so the state is loaded in place (`load_state_dict`,
    `checkpoint.restore_checkpoint`), never rebuilt under a graph."""

    def __init__(self, model: GroundEstimatorNet, tx: Optimizer,
                 step: int = 0, dynamic_scale: DynamicScale | None = None):
        self.model, self.tx = model, tx
        self.dynamic_scale = dynamic_scale
        self.step_t = torch.full((), int(step), dtype=torch.int32,
                                 device=model.device)
        self._step = int(step)

    @property
    def step(self) -> int:
        return self._step

    @step.setter
    def step(self, value: int) -> None:
        self._step = int(value)
        self.step_t.fill_(self._step)

    def tensors(self) -> list:
        """Every tensor a train step changes in place."""
        ds = self.dynamic_scale
        return (list(self.model.state_dict(keep_vars=True).values())
                + self.tx.momentum + [self.tx.count_t, self.step_t]
                + ([] if ds is None else [ds.scale_t, ds.fin_steps_t]))

    def state_dict(self) -> dict:
        return {**self.tx.state_dict(), "step": self.step,
                "dynamic_scale": (None if self.dynamic_scale is None
                                  else self.dynamic_scale.state_dict())}

    def load_state_dict(self, sd: dict) -> None:
        """Load in place: the optimizer's tensors, the step count and the
        loss scale (made where the state had none, dropped where the
        checkpoint has none; a graph of the step is then captured
        anew)."""
        self.tx.load_state_dict(sd)
        self.step = int(sd.get("step", sd["count"]))
        ds = sd.get("dynamic_scale")
        if ds is None:
            self.dynamic_scale = None
        elif self.dynamic_scale is None:
            self.dynamic_scale = DynamicScale(**ds, device=self.model.device)
        else:
            self.dynamic_scale.load_state_dict(ds)


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
                      dynamic_scale=(DynamicScale(device=model.device)
                                     if loss_scaling else None))


def loss_fn(cfg: GndNetConfig) -> Callable:
    return lambda pred, labels: losses.total_loss(pred, labels, cfg.alpha,
                                                  cfg.beta)


def _as_batch(state: TrainState, points, labels):
    dev = state.model.device
    with span("gndnet.train.batch"):
        return (torch.as_tensor(points, dtype=torch.float32, device=dev),
                torch.as_tensor(labels, dtype=torch.float32, device=dev))


def _predict(model: GroundEstimatorNet, cfg: GndNetConfig, points,
             train: bool, use_pillar_path: bool, reference: bool = False):
    if not use_pillar_path:
        return model.fused(points, train=train, reference=reference)
    pb = pz.pillarize_batch(points, model.geom, cfg.max_points_voxel,
                            cfg.max_voxels)
    return model(pb.voxels, pb.coors, pb.num_points, pb.mask, train=train)


class _Program:
    """`body(state, *tensors)` -> tensor, on a CUDA state as one CUDA
    graph per state, loss scale and shapes and types of the tensors
    (`utils.graphs.GraphCache`: `jax.jit`'s cache), eagerly on the CPU or
    when `eager`.  The graphs of a state live as long as it does (held by
    a weak reference); the loss scale's Python fields are part of the key,
    so loading other values into it captures anew.  `mutates`: the body
    changes the state in place, so each capture's warm-up puts back every
    tensor of `TrainState.tensors`.  `replays` counts the replays,
    `eager_steps` the bodies run outside a replay (eagerly, in a warm-up or
    recorded by a capture)."""

    def __init__(self, body: Callable, eager: bool, mutates: bool):
        self.body, self.eager, self.mutates = body, eager, mutates
        self.caches = weakref.WeakKeyDictionary()
        self.replays = self.eager_steps = 0

    def __call__(self, state: TrainState, *tensors):
        if self.eager or state.model.device.type != "cuda":
            self.eager_steps += 1
            with span("gndnet.graph.eager"):
                return self.body(state, *tensors)
        by_scale = self.caches.setdefault(state, {})
        ds = state.dynamic_scale
        key = None if ds is None else (
            id(ds), ds.growth_factor, ds.backoff_factor, ds.growth_interval,
            ds.minimum_scale)
        entry = by_scale.get(key)
        if entry is None:
            # the entry holds the scale, so its id stays its own; the
            # graph's closures hold the state weakly
            ref = weakref.ref(state)
            entry = by_scale[key] = (ds, GraphCache(
                lambda *a: self.body(ref(), *a),
                (lambda: ref().tensors()) if self.mutates else None))
        cache = entry[1]
        replays, eager = cache.replays, cache.eager_calls
        out = cache(*tensors)
        self.replays += cache.replays - replays
        self.eager_steps += cache.eager_calls - eager
        return out


class TrainStep:
    """The train step of `make_train_step`: (state, points, labels) ->
    (state, loss).  While a profiler collects, a step is the host span
    `gndnet.train.step`, holding `gndnet.train.batch` (the host batch's
    copy) and the graph's `gndnet.graph.replay`, `capture` or `eager`."""

    def __init__(self, cfg: GndNetConfig, augment: bool, reference: bool,
                 use_pillar_path: bool, eager: bool):
        self.cfg, self.augment = cfg, augment
        total = loss_fn(cfg)

        def body(state: TrainState, points, labels, *draws):
            if draws:
                ang, dz = draws
                points, labels = aug.apply_augment(
                    points, labels, aug.euler_zyx_matrices(ang), dz, cfg)
            model, ds = state.model, state.dynamic_scale
            # batch norm updates its running statistics in the forward
            saved = ([v.clone() for v in model.buffers()]
                     if ds is not None else None)
            with no_tf32(model.encoder_decoder.full_f32(model.device)):
                loss = total(_predict(model, cfg, points, True,
                                      use_pillar_path, reference), labels)
                state.tx.zero_grad()
                if ds is not None:
                    loss = loss * ds.scale_t
                loss.backward()
            state.step_t += 1
            if ds is None:
                state.tx.step()
                return loss.detach()
            finite = ds.unscale_(state.tx.params)
            loss = loss.detach() / ds.scale_t
            ds.update(finite)
            select_(~finite, list(model.buffers()), saved)
            state.tx.step(finite)
            return loss

        self.program = _Program(body, eager or reference, mutates=True)

    @property
    def replays(self) -> int:
        return self.program.replays

    @property
    def eager_steps(self) -> int:
        return self.program.eager_steps

    def __call__(self, state: TrainState, points, labels):
        with span("gndnet.train.step"):
            points, labels = _as_batch(state, points, labels)
            draws = ()
            if self.augment:
                draws = aug.augment_draws(aug.augment_generator(
                    AUGMENT_SEED, state.step, points.device),
                    points.shape[0], self.cfg)
            loss = self.program(state, points, labels, *draws)
            state._step += 1
        return state, loss


def make_train_step(cfg: GndNetConfig, augment: bool = False,
                    reference: bool = False, use_pillar_path: bool = False,
                    eager: bool = False) -> TrainStep:
    """(state, points (B, N, F), labels (B, ny, nx)) -> (state, loss): one
    forward with batch statistics, backward, and optimizer step; the state
    is updated in place.  The loss is a device tensor and the step reads
    nothing back to the host.  At float32 / 'highest' on the card TF32
    stays off through the backward too.  `reference=True` runs the plain
    version of every kernel stage.  `use_pillar_path=True` takes the
    reference-style path (`pillarize_batch`, then `forward`), which runs
    every configuration.

    On a CUDA state the first call with a given state and (B, N, F) batch
    warms up and captures the whole step (augmentation, forward, loss,
    backward, unscale and finite flag, clip, update, the step and count
    increments) as one CUDA graph, then replays it; later calls replay it
    (the batch is copied into the graph's static inputs first; pass device
    tensors, or the copy waits on the host).  The warm-up leaves the
    state as it was.  `eager=True` (and `reference=True`, and a CPU state)
    runs the step eagerly instead, the same operations in the same order.
    The returned step's `replays` and `eager_steps` count both.

    `augment=True` first rotates and lifts the batch and its labels on the
    device (`data.augmentation`), with the draws of a generator seeded
    from (AUGMENT_SEED, state.step): a fresh draw every step, the same draw
    for the same step (the JAX package's fold_in(PRNGKey(0), step)).  The
    draws are made before the step, outside its graph, and are an input
    of it.

    With `state.dynamic_scale` the backward runs on the scaled loss and
    the gradients are unscaled; when one is not finite the step keeps the
    parameters, momentum, update count and batch-norm statistics (by
    `torch.where` on the device's finite flag), and the scale backs off.
    The returned loss is then scaled loss / scale, as flax returns it."""
    return TrainStep(cfg, augment, reference, use_pillar_path, eager)


class EvalStep:
    """The eval step of `make_eval_step`: (state, points, labels) ->
    loss."""

    def __init__(self, cfg: GndNetConfig, use_pillar_path: bool,
                 eager: bool):
        total = loss_fn(cfg)

        def body(state: TrainState, points, labels):
            return total(_predict(state.model, cfg, points, False,
                                  use_pillar_path), labels)

        self.program = _Program(body, eager, mutates=False)

    def __call__(self, state: TrainState, points, labels):
        return self.program(state, *_as_batch(state, points, labels))


def make_eval_step(cfg: GndNetConfig, use_pillar_path: bool = False,
                   eager: bool = False) -> EvalStep:
    """(state, points, labels) -> loss with running statistics, no grad,
    no state change; `use_pillar_path` and `eager` as in
    `make_train_step` (one CUDA graph per state and batch shape on the
    card)."""
    return EvalStep(cfg, use_pillar_path, eager)


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
