"""Ground-truth dataset generation CLI.

Counterpart of `scripts/generate_data.py` (the reference's
semKitti_morph_data_camera.py / semKitti_morph_data.py scripts,
semKitti_morph_data_camera.py:316-371): converts raw SemanticKITTI
sequences into reduced_velo / gnd_labels training pairs, block-parallel
across processes, each on `--device`.

Example:
  python -m gndnet_tpu_torch.scripts.generate_data --config camera \\
      --data_dir /data/semantic_kitti --out_dir /data/gnd_training \\
      --sequences 00 01 02 [--device cpu]
"""

import argparse
import dataclasses


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="kitti_sem")
    p.add_argument("--data_dir", required=True,
                   help="SemanticKITTI root (contains sequences/)")
    p.add_argument("--out_dir", default="",
                   help="output root (default: config data_prep.out_dir)")
    p.add_argument("--sequences", nargs="*", default=None)
    p.add_argument("--num_workers", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    from gndnet_tpu_torch.config import load_config
    from gndnet_tpu_torch.data.generator import generate_dataset
    from gndnet_tpu_torch.utils.logging import setup_logger

    logger = setup_logger("dataprep", "dataprep.log")
    cfg = load_config(args.config)
    if args.num_workers is not None:
        cfg = cfg.replace(data_prep=dataclasses.replace(
            cfg.data_prep, num_workers=args.num_workers))
    out_dir = args.out_dir or cfg.data_prep.out_dir
    if not out_dir:
        p.error("--out_dir required (config data_prep.out_dir is empty)")

    n = generate_dataset(args.data_dir, out_dir, cfg,
                         sequences=args.sequences, logger=logger,
                         device=args.device)
    logger.info("generated %d frames into %s", n, out_dir)


if __name__ == "__main__":
    main()
