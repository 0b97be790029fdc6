"""Rank programs for `multihost.spawn`: what every rank of a localhost
run executes, each returning host tensors to the launching process.

They drive the parallel modules the way a user's program would (mesh,
shard, replicate, step) at a size the caller picks, and serve
`scripts/launch_multihost.py`, the CPU tests (which compare the results
with the JAX package and with the single-device port in the launching
process) and the card smoke test.  Every job takes (rank, world, device)
first; `device` is this rank's.
"""

from __future__ import annotations

import numpy as np
import torch

from gndnet_tpu_torch import train
from gndnet_tpu_torch.models.gndnet import GroundEstimatorNet
from gndnet_tpu_torch.parallel import mesh as pmesh
from gndnet_tpu_torch.parallel import multihost, spatial, tp


def _host(sd: dict) -> dict:
    return {k: v.detach().cpu().clone() for k, v in sd.items()}


def _index(mesh) -> dict:
    return {"dp": mesh.get_local_rank("dp"), "sp": mesh.get_local_rank("sp")}


def infer_job(rank, world, device, cfg, state_dict, points, dp, sp,
              labels=None) -> dict:
    """Eval-mode inference of the dp x sp mesh on the global batch
    `points` (every rank holds it and takes its dp shard): `make_dp_infer`
    (and, given labels, `make_dp_eval_step`) at sp == 1,
    `make_spatial_infer` otherwise.  Returns this rank's mesh index and
    its (B/dp, ny, nx) output."""
    mesh = pmesh.make_mesh(dp, sp)
    model = GroundEstimatorNet(cfg, device=device)
    model.load_state_dict(state_dict)
    pmesh.replicate(mesh, model)
    batch = [points] if labels is None else [points, labels]
    local = pmesh.shard_batch(mesh, batch, device)
    out = {**_index(mesh)}
    if sp == 1:
        out["out"] = pmesh.make_dp_infer(cfg, mesh)(model, local[0]).cpu()
        if labels is not None:
            state = train.create_train_state(cfg, 10, state_dict=state_dict,
                                             device=device)
            out["eval"] = float(pmesh.make_dp_eval_step(cfg, mesh)(
                state, *local))
    else:
        out["out"] = spatial.make_spatial_infer(cfg, mesh)(model,
                                                           local[0]).cpu()
    return out


def train_job(rank, world, device, cfg, state_dict, points, labels, dp, sp,
              steps=1, augment=False) -> dict:
    """`steps` mesh train steps (the dp step at sp == 1, the spmd step
    otherwise) from `state_dict` on the global batch (every rank takes its
    dp shard).  Returns the losses and the final state dict."""
    mesh = pmesh.make_mesh(dp, sp)
    state = train.create_train_state(cfg, 10, state_dict=state_dict,
                                     device=device)
    pmesh.replicate(mesh, state)
    batch = pmesh.shard_batch(mesh, (points, labels), device)
    step = (spatial.make_spmd_train_step if sp > 1 else
            pmesh.make_dp_train_step)(cfg, mesh, augment=augment)
    losses = []
    for _ in range(steps):
        state, loss = step(state, *batch)
        losses.append(float(loss))
    return {**_index(mesh), "losses": losses,
            "state_dict": _host(state.model.state_dict())}


def halo_job(rank, world, device, x, weight, bias, probe) -> dict:
    """The sharded 3x3 conv of `halo_exchange` on this rank's slab of the
    NCHW image `x` (sp = world), and the gradient of sum(out * probe) in
    the slab and the conv parameters."""
    mesh = pmesh.make_mesh(1, world)
    group = mesh.get_group("sp")
    hl = x.shape[2] // world
    rows = slice(rank * hl, (rank + 1) * hl)
    slab = torch.as_tensor(x)[:, :, rows].clone().requires_grad_(True)
    w = torch.as_tensor(weight).clone().requires_grad_(True)
    b = torch.as_tensor(bias).clone().requires_grad_(True)
    out = spatial._conv3x3(spatial.halo_exchange(slab, group), w, b)
    (out * torch.as_tensor(probe)[:, :, rows]).sum().backward()
    return {"out": out.detach(), "grad": slab.grad, "grad_w": w.grad,
            "grad_b": b.grad}


def tp_job(rank, world, device, cfg, state_dict, points) -> dict:
    """The tp forward over `world` ranks from this rank's shard of
    `state_dict`; returns its output and how many tensors it holds
    sharded."""
    mesh = tp.make_tp_mesh(world)
    shards = {k: v.to(device) for k, v in
              tp.tp_shard_variables(state_dict, mesh).items()}
    out = tp.make_tp_infer(cfg, mesh)(shards, points)
    return {"out": out.cpu(), "sharded": sum(
        shards[k].shape != state_dict[k].shape for k in shards)}


def resume_job(rank, world, device, cfg, workdir, dp, sp, epochs,
               resume_at) -> dict:
    """`train_and_evaluate` over the mesh, once for `epochs` epochs in
    workdir/full, once for `resume_at` epochs then resumed to `epochs` in
    workdir/resumed; returns both runs' losses and final state dicts."""
    kw = dict(train_skip=1, valid_skip=1, print_freq=1, dp=dp, sp=sp,
              device=device)
    full = train.train_and_evaluate(cfg, workdir=f"{workdir}/full",
                                    epochs=epochs, **kw)
    first = train.train_and_evaluate(cfg, workdir=f"{workdir}/resumed",
                                     epochs=resume_at, **kw)
    rest = train.train_and_evaluate(cfg, workdir=f"{workdir}/resumed",
                                    epochs=epochs, resume=True, **kw)
    return {"full": full["train_loss"],
            "resumed": first["train_loss"] + rest["train_loss"],
            "full_state": _host(full["state"].model.state_dict()),
            "resumed_state": _host(rest["state"].model.state_dict()),
            "steps": (full["state"].step, rest["state"].step)}


def synthetic_batch(cfg, rng: np.random.Generator, b: int, n: int):
    """A sloped ground plane of `b` scans of `n` points and its heights
    (the launcher's data)."""
    pts = np.zeros((b, n, cfg.input_features), np.float32)
    pts[..., 0] = rng.uniform(cfg.pc_range[0] + 0.1, cfg.pc_range[3] - 0.1,
                              (b, n))
    pts[..., 1] = rng.uniform(cfg.pc_range[1] + 0.1, cfg.pc_range[4] - 0.1,
                              (b, n))
    pts[..., 2] = 0.05 * pts[..., 0] - 0.5 + rng.normal(0, 0.05, (b, n))
    xs = (np.arange(cfg.nx) + 0.5) * cfg.voxel_size[0] + cfg.pc_range[0]
    labels = np.broadcast_to((0.05 * xs - 0.5)[None, None, :],
                             (b, cfg.ny, cfg.nx)).astype(np.float32)
    return pts, labels


def cli_job(rank, world, device, argv) -> dict:
    """The train CLI in every rank (`scripts.train.main(argv)`), as
    torchrun would start it: WORLD_SIZE set, the process group up."""
    import os

    from gndnet_tpu_torch.scripts import train as train_cli

    os.environ["WORLD_SIZE"] = str(world)
    hist = train_cli.main(argv)
    return {"train_loss": hist["train_loss"],
            "valid_loss": hist["valid_loss"],
            "state_dict": _host(hist["state"].model.state_dict())}


def replicate_job(rank, world, device, n_frames) -> dict:
    """`process_slice`, the mesh axes, and `replicate_global` on values
    that agree and on values that differ on the last rank."""
    mesh = multihost.global_mesh(world, 1)
    tree = {"a": np.arange(6.0, dtype=np.float32) + 0.0,
            "b": [np.ones((2, 2), np.float32)]}
    same = multihost.replicate_global(mesh, tree, device)
    differ = {"a": np.arange(6.0, dtype=np.float32) + (rank == world - 1)}
    try:
        multihost.replicate_global(mesh, differ, device)
        error = None
    except ValueError as e:
        error = str(e)
    sl = multihost.process_slice(n_frames, 4)
    return {"slice": (sl.start, sl.stop), "axis": multihost.axis(mesh, "dp")[1:],
            "same": same["a"].cpu(), "error": error}
