"""Training CLI.

Counterpart of `scripts/train.py` (the reference's training.py:63-70
flags: --config / --resume / --evaluate / --save_checkpoints / --print-freq,
plus --workdir, --epochs and the rest), with `--device`.  Writes
<workdir>/training.log and, with -s, checkpoints to <workdir>/checkpoints
(a `checkpoint.CheckpointManager`).

Example:
  python -m gndnet_tpu_torch.scripts.train --config kitti_sem -s \\
      --workdir runs/kitti [--impl affine --bf16] [--device cpu]
  python -m gndnet_tpu_torch.scripts.train --config my.yaml --resume \\
      --workdir runs/kitti
  torchrun --nproc_per_node=4 -m gndnet_tpu_torch.scripts.train \\
      --config kitti_sem -s --workdir runs/kitti --dp 2 --sp 2

With dp * sp > 1 the CLI runs one process per rank (torchrun sets
WORLD_SIZE, RANK, LOCAL_RANK and the rendezvous); each rank trains on
its card, rank 0 writes the log and the checkpoints.
"""

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="kitti_sem",
                   help="preset name or YAML path")
    p.add_argument("--print-freq", "-p", default=100, type=int, metavar="N")
    p.add_argument("--resume", action="store_true",
                   help="resume from the workdir's latest checkpoint")
    p.add_argument("-e", "--evaluate", action="store_true",
                   help="only run validation (on the latest checkpoint)")
    p.add_argument("-s", "--save_checkpoints", action="store_true")
    p.add_argument("--workdir", default=".")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--data_dir", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--train_skip", type=int, default=6,
                   help="use every k-th training frame (reference skip=6)")
    p.add_argument("--valid_skip", type=int, default=3)
    p.add_argument("--impl", default=None,
                   choices=[None, "scatter", "affine", "sorted"],
                   help="fused frontend override: 'affine' trains through "
                        "the K3/K5/K6 (bf16) or K3/K4/K6 (f32) kernels; "
                        "default keeps the config's impl")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 convs at 'default' precision (the "
                        "serving settings) for training")
    p.add_argument("--augment", action="store_true",
                   help="on-device augmentation inside the train step "
                        "(rotation and height, labels co-transformed; "
                        "drawn from the step count, so resumes repeat it)")
    p.add_argument("--dp", type=int, default=None,
                   help="data-parallel size (default: WORLD_SIZE // sp); "
                        "dp * sp > 1 runs one process per rank")
    p.add_argument("--sp", type=int, default=1,
                   help="spatial-parallel size (pseudo-image height "
                        "sharded; requires use_norm off)")
    p.add_argument("--cache_dir", default=None,
                   help="directory the kernel libraries are built into and "
                        "loaded from (utils/compile_cache.py)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    from gndnet_tpu_torch.config import load_config
    from gndnet_tpu_torch.train import train_and_evaluate
    from gndnet_tpu_torch.utils.logging import setup_logger

    if args.cache_dir:
        from gndnet_tpu_torch.utils.compile_cache import \
            enable_compilation_cache

        enable_compilation_cache(args.cache_dir)

    cfg = load_config(args.config)
    if args.data_dir:
        cfg = cfg.replace(data_dir=args.data_dir)
    if args.impl:
        cfg = cfg.replace(fused_impl=args.impl)
    if args.bf16:
        cfg = cfg.replace(compute_dtype="bfloat16",
                          matmul_precision="default")
    sp, dp = args.sp, args.dp
    world = int(os.environ.get("WORLD_SIZE", 1))
    if dp is None:
        dp = max(world // sp, 1)
    if dp * sp > world:
        raise ValueError(
            f"--dp {dp} x --sp {sp} needs {dp * sp} ranks, this run has "
            f"{world} (WORLD_SIZE): launch one process per rank, e.g. "
            f"torchrun --nproc_per_node={dp * sp} -m "
            "gndnet_tpu_torch.scripts.train ...")
    rank = 0
    if dp * sp > 1:
        import torch.distributed as dist

        from gndnet_tpu_torch.parallel import multihost

        if not dist.is_initialized():
            multihost.initialize(backend=multihost.choose_backend(
                args.device, int(os.environ.get("LOCAL_WORLD_SIZE", world))))
        rank = dist.get_rank()
    os.makedirs(args.workdir, exist_ok=True)
    logger = setup_logger(
        "train" if rank == 0 else f"train_rank{rank}",
        os.path.join(args.workdir, "training.log") if rank == 0 else None)
    logger.info("config: %s", args.config)

    kw = dict(workdir=args.workdir, print_freq=args.print_freq,
              seed=args.seed, train_skip=args.train_skip,
              valid_skip=args.valid_skip, dp=dp, sp=sp, logger=logger,
              device=args.device)
    if args.evaluate:
        hist = train_and_evaluate(cfg, epochs=0, resume=True,
                                  save_checkpoints=False, **kw)
        logger.info("validation only: loss %.6f", hist["valid_loss"][-1])
        return hist
    hist = train_and_evaluate(cfg, epochs=args.epochs, resume=args.resume,
                              save_checkpoints=args.save_checkpoints,
                              augment=args.augment, **kw)
    logger.info("done: lowest validation loss %.6f", hist["lowest_loss"])
    return hist


if __name__ == "__main__":
    main()
