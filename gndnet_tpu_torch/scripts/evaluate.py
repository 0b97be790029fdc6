"""SemanticKITTI evaluation CLI.

Counterpart of `scripts/evaluate.py` (reference evaluate_SemanticKITTI.py:
48-56): per-frame IoU / precision / recall / masked height MSE and their
averages over a sequence, printed as a dict.

Example:
  python -m gndnet_tpu_torch.scripts.evaluate --config kitti_sem \\
      --data_dir data/testing/00 --resume checkpoint.pth.tar [--device cpu]
"""

import argparse


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="kitti_sem")
    p.add_argument("--data_dir", required=True,
                   help="sequence dir with velodyne/ and labels/")
    p.add_argument("--resume", default="", help="a .pth.tar or a "
                   "CheckpointManager directory")
    p.add_argument("--threshold", type=float, default=0.0,
                   help="segmentation threshold (reference eval uses 0)")
    p.add_argument("--corrected", action="store_true",
                   help="use corrected heightmap semantics instead of "
                        "reference-bug-compatible MSE")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    from gndnet_tpu_torch.config import load_config
    from gndnet_tpu_torch.evaluate import evaluate_semantic_kitti
    from gndnet_tpu_torch.utils.logging import setup_logger
    from gndnet_tpu_torch.weights import init_state_dict

    logger = setup_logger("evaluate")
    cfg = load_config(args.config)
    state_dict = init_state_dict(cfg)
    if args.resume:
        from gndnet_tpu_torch.checkpoint import load_weights

        state_dict = load_weights(args.resume, cfg)

    result = evaluate_semantic_kitti(
        cfg, state_dict, args.data_dir, threshold=args.threshold,
        reference_compat=not args.corrected, logger=logger,
        device=args.device)
    print(result.as_dict())


if __name__ == "__main__":
    main()
