"""Multi-process SPMD launcher: one process per rank over torch.distributed.

Counterpart of `scripts/launch_multihost.py`.  Every rank runs this
script with the same arguments; the process group comes from the
environment (`torchrun` sets it) or from --coordinator / --num-processes
/ --process-id.  The ranks build one global (dp, sp) mesh (dp = world //
sp), each feeds its local batch shard, and the dp x sp training step of
`parallel/spatial.py` runs unchanged; every rank prints its losses, which
must be identical (the SPMD invariant).

    torchrun --nproc_per_node=4 -m gndnet_tpu_torch.scripts.launch_multihost \\
        --sp 2 --steps 100
    python -m gndnet_tpu_torch.scripts.launch_multihost --coordinator \\
        host0:29500 --num-processes 8 --process-id $RANK --sp 2

Ranks run on the cards (each on card LOCAL_RANK modulo the cards) and
the run raises where there is none; `--device cpu` runs CPU ranks over
gloo.  `multihost.choose_backend` picks NCCL or gloo.

Localhost self-test: `--spawn N` starts N ranks through
`parallel.multihost.spawn`, prints every rank's lines and exits non-zero
unless all ranks report the same losses:

    python -m gndnet_tpu_torch.scripts.launch_multihost --spawn 2 \\
        --device cpu
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _config(name: str):
    from gndnet_tpu_torch.config import GndNetConfig, load_config

    if name != "tiny":
        return load_config(name)
    return GndNetConfig(
        pc_range=(0.0, -8.0, -4.0, 16.0, 8.0, 4.0),
        grid_range=(0.0, -8.0, 16.0, 8.0), voxel_size=(1.0, 1.0, 8.0),
        max_points_voxel=16, max_voxels=256, input_features=4,
        use_norm=False)


def worker(rank: int, world: int, device: str, config: str = "tiny",
           sp: int = 1, steps: int = 2, augment: bool = False) -> list:
    """One rank's run (the process group is up): the spmd train step on
    this rank's synthetic local shard, two scans a dp shard, the same on
    the sp ranks of a dp row.  Returns (and prints) its lines."""
    from gndnet_tpu_torch import train
    from gndnet_tpu_torch.parallel import multihost, spatial
    from gndnet_tpu_torch.parallel.rank_jobs import synthetic_batch

    cfg = _config(config)
    mesh = multihost.global_mesh(world // sp, sp)
    _, dp, dp_index = multihost.axis(mesh, "dp")
    lines = [f"[rank {rank}/{world}] device={device} mesh dp={dp} x sp={sp}"]
    print(lines[-1], flush=True)
    state = train.create_train_state(cfg, 10, device=device)
    multihost.replicate_global(mesh, state)
    step = spatial.make_spmd_train_step(cfg, mesh, augment=augment)
    rng = np.random.default_rng(1234 + dp_index)
    points, labels = synthetic_batch(cfg, rng, 2, min(cfg.num_points, 256))
    batch = multihost.local_batch_to_global(mesh, (points, labels), device)
    for i in range(steps):
        state, loss = step(state, *batch)
        lines.append(f"[rank {rank}] step {i} loss {float(loss):.6f}")
        print(lines[-1], flush=True)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0, or an init URL "
                         "(default: the environment, as torchrun sets it)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default: this rank's card) or 'cpu'")
    ap.add_argument("--sp", type=int, default=1)
    ap.add_argument("--augment", action="store_true",
                    help="on-device augmentation inside the SPMD step "
                         "(drawn from the step and the dp index; the sp "
                         "ranks of a dp row share one transform)")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--config", default="tiny")
    ap.add_argument("--spawn", type=int, default=0,
                    help="localhost self-test: start N ranks and check "
                         "that they print the same losses")
    args = ap.parse_args(argv)
    job = dict(config=args.config, sp=args.sp, steps=args.steps,
               augment=args.augment)
    if args.spawn:
        from gndnet_tpu_torch.parallel import multihost

        results = multihost.spawn(
            "gndnet_tpu_torch.scripts.launch_multihost:worker", args.spawn,
            kwargs=job, device=args.device)
        for lines in results:
            print("\n".join(lines), flush=True)
        losses = [[ln.split(" loss ")[1] for ln in lines if " loss " in ln]
                  for lines in results]
        same = all(x == losses[0] for x in losses)
        print(f"ranks agree: {same}", flush=True)
        return 0 if same else 1

    import os

    import torch.distributed as dist

    from gndnet_tpu_torch.parallel import multihost

    world = args.num_processes or int(os.environ.get("WORLD_SIZE", 1))
    multihost.initialize(
        args.coordinator, args.num_processes, args.process_id,
        backend=multihost.choose_backend(
            args.device, int(os.environ.get("LOCAL_WORLD_SIZE", world))))
    try:
        worker(dist.get_rank(), dist.get_world_size(),
               str(multihost.local_device(args.device)), **job)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
