"""Checkpoint converter: reference .pth.tar <-> a `CheckpointManager`
directory.

Counterpart of `scripts/convert_checkpoint.py` (reference .pth.tar <->
the JAX package's orbax directory).  Both directions copy the state dict's
tensors unchanged (bit-true); the weights are checked against `--config`
by loading them into the model on the CPU.  A `.pth.tar` written here is
the reference's dict (training.py:300-305): `epoch`, `state_dict`,
`lowest_loss`, `optimizer` (the source's, else empty).

Examples:
  python -m gndnet_tpu_torch.scripts.convert_checkpoint --config kitti_sem \\
      --from-torch checkpoint.pth.tar --to-dir ckpts/
  python -m gndnet_tpu_torch.scripts.convert_checkpoint --config kitti_sem \\
      --from-dir runs/kitti/checkpoints --to-torch exported.pth.tar
"""

import argparse


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="kitti_sem")
    p.add_argument("--from-torch", default="", metavar="PTH")
    p.add_argument("--from-dir", default="", metavar="DIR")
    p.add_argument("--to-torch", default="", metavar="PTH")
    p.add_argument("--to-dir", default="", metavar="DIR")
    args = p.parse_args(argv)
    if bool(args.from_torch) == bool(args.from_dir):
        p.error("exactly one of --from-torch / --from-dir is required")
    if not (args.to_torch or args.to_dir):
        p.error("at least one of --to-torch / --to-dir is required")

    import torch

    from gndnet_tpu_torch.checkpoint import CheckpointManager
    from gndnet_tpu_torch.config import load_config
    from gndnet_tpu_torch.models.gndnet import GroundEstimatorNet

    cfg = load_config(args.config)
    if args.from_torch:
        ckpt = torch.load(args.from_torch, map_location="cpu",
                          weights_only=False)
        if "state_dict" not in ckpt:     # a bare state dict
            ckpt = {"state_dict": ckpt}
    else:
        ckpt = CheckpointManager(args.from_dir).restore()
        if ckpt is None:
            raise SystemExit(f"no checkpoint found in {args.from_dir}")
    state_dict = {(k[7:] if k.startswith("module.") else k): v
                  for k, v in ckpt["state_dict"].items()}
    model = GroundEstimatorNet(cfg, device="cpu")
    model.load_state_dict(state_dict)            # names and shapes
    epoch = int(ckpt.get("epoch", 0))
    lowest = float(ckpt.get("lowest_loss", float("inf")))
    n = sum(p.numel() for p in model.parameters())
    print(f"loaded: epoch {epoch}, lowest_loss {lowest}, {n/1e6:.2f}M params")

    out = {"epoch": epoch, "state_dict": state_dict, "lowest_loss": lowest,
           "optimizer": ckpt.get("optimizer", {})}
    if args.to_dir:
        mgr = CheckpointManager(args.to_dir)
        mgr.save(max(epoch, 1), out)
        mgr.close()
        print(f"wrote checkpoint directory {args.to_dir}")
    if args.to_torch:
        torch.save(out, args.to_torch)
        print(f"wrote torch checkpoint to {args.to_torch}")


if __name__ == "__main__":
    main()
