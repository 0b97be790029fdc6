"""Device mesh and data-parallel training and inference.

Counterpart of `gndnet_tpu.parallel.mesh`.  The reference has NO
distributed training (one `.cuda()` device, reference: training.py:98;
its Slurm jobs are independent 1-GPU runs,
run_model_training_cluster.sh:1-17).  The JAX package runs an SPMD mesh
under `shard_map`; here every rank is a process of its own
(`parallel.multihost`) and the collectives are explicit:

* mesh dim "dp": batch-sharded data parallelism.  Each rank runs the
  port's ordinary fused step (`train.make_train_step`'s body) on its local
  batch; the gradients and the loss are averaged over dp (one flattened
  all-reduce), and batch norm runs as sync-BN over dp (`fused(...,
  bn_group=)`: per-channel sums AND row counts are summed), so a dp=K
  step matches the single-device step on the concatenated batch.
* mesh dim "sp": spatial parallelism over the pseudo-image height
  (`parallel.spatial`).

Functions here take this rank's LOCAL batch shard (`shard_batch` slices
it from a batch every rank holds; `multihost.local_batch_to_global` keeps
one each rank loaded) and return this rank's results: `make_dp_infer`
gives this rank's dp shard of the elevation maps.
"""

from __future__ import annotations

from typing import Callable

import torch

from gndnet_tpu_torch import train
from gndnet_tpu_torch.config import GndNetConfig
from gndnet_tpu_torch.data import augmentation as aug
from gndnet_tpu_torch.models.segnet import no_tf32
from gndnet_tpu_torch.parallel import collectives as cc
from gndnet_tpu_torch.parallel import multihost


def make_mesh(dp: int = 1, sp: int = 1):
    """A (dp, sp) mesh over every rank of the process group (one device a
    rank); raises unless dp * sp ranks run."""
    return multihost.global_mesh(dp, sp)


def shard_batch(mesh, batch, device=None):
    """This rank's dp slice of (points, labels, ...), arrays or tensors
    with the global batch first, as tensors on this rank's device."""
    _, dp, i = multihost.axis(mesh, "dp")
    dev = multihost.local_device(device)
    out = []
    for x in batch:
        x = torch.as_tensor(x)
        if x.shape[0] % dp:
            raise ValueError(f"batch {x.shape[0]} does not divide by dp={dp}")
        per = x.shape[0] // dp
        out.append(x[i * per:(i + 1) * per].to(dev))
    return tuple(out)


def replicate(mesh, tree, device=None):
    """The same values on every rank: rank 0's, broadcast in place
    (`multihost.replicate_global`, which also checks they were equal)."""
    return multihost.replicate_global(mesh, tree, device)


def _check_state(state) -> None:
    if state.dynamic_scale is not None:
        raise ValueError("loss scaling is a single-device option: the mesh "
                         "train steps take no DynamicScale, as in the JAX "
                         "package")


def augment_local(cfg: GndNetConfig, state, points, labels, dp_index: int):
    """The on-device augmentation of the train step, drawn from a generator
    seeded from (AUGMENT_SEED, step, dp index): dp shards draw distinct
    transforms, the ranks of one dp row the same one (the JAX package's
    fold_in of the dp axis index)."""
    return aug.device_augment(points, labels, aug.augment_generator(
        train.AUGMENT_SEED, state.step, points.device, rank=dp_index), cfg)


def make_dp_train_step(cfg: GndNetConfig, mesh,
                       augment: bool = False) -> Callable:
    """(state, points, labels) -> (state, loss), this rank's local batch
    shard in; the state (replicated) is updated in place and the loss is
    the mean over dp.  The forward uses sync-BN over dp; the gradients are
    averaged over dp before the optimizer step.

    `augment=True` applies the single-device step's on-device
    augmentation with the dp index folded into the seed, so shards draw
    distinct transforms (same distribution as the single-device step, not
    the same draws)."""
    total = train.loss_fn(cfg)
    group, _, dp_index = multihost.axis(mesh, "dp")

    def step(state, points, labels):
        _check_state(state)
        points, labels = train._as_batch(state, points, labels)
        if augment:
            points, labels = augment_local(cfg, state, points, labels,
                                           dp_index)
        model = state.model
        with no_tf32(model.encoder_decoder.full_f32(model.device)):
            loss = total(model.fused(points, train=True, bn_group=group),
                         labels)
            state.tx.zero_grad()
            loss.backward()
        cc.pmean_grads_(state.tx.params, group)
        state.step += 1
        state.tx.step()
        return state, cc.all_reduce(loss.detach(), group) / cc.size(group)

    return step


def make_dp_eval_step(cfg: GndNetConfig, mesh) -> Callable:
    """(state, points, labels) -> the loss with running statistics over
    this rank's shard, averaged over dp."""
    total = train.loss_fn(cfg)
    group, dp, _ = multihost.axis(mesh, "dp")

    def step(state, points, labels):
        points, labels = train._as_batch(state, points, labels)
        loss = total(state.model.fused(points, train=False), labels)
        return cc.all_reduce(loss, group) / dp

    return step


def make_dp_infer(cfg: GndNetConfig, mesh) -> Callable:
    """Batch-sharded fused inference: (model, points (B/dp, N, F), this
    rank's shard) -> (B/dp, ny, nx)."""
    del cfg, mesh

    def infer(model, points):
        points = torch.as_tensor(points, dtype=torch.float32,
                                 device=model.device)
        return model.fused(points, train=False)

    return infer
