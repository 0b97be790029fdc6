"""Augmentation eyeball tool: N random augmentations of a scan, each written
as a PNG (top view coloured by z, side profile) beside the original.

Counterpart of `scripts/augmentation_demo.py` (reference
augmentation_demo.py:115-187, which loops random augmentations into rviz),
on the port's host pipeline `data.augmentation.AugmentationPipeline`.

Example:
  python -m gndnet_tpu_torch.scripts.augmentation_demo --config camera \\
      --pcl data/training/seq_000/reduced_velo/000000.npy --n 4 --out aug
"""

import argparse
import os
import tempfile

import numpy as np


def render(path, cloud, title):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    step = max(1, len(cloud) // 30000)
    c = cloud[::step]
    axes[0].scatter(c[:, 0], c[:, 1], s=0.2, c=c[:, 2], cmap="viridis")
    axes[0].set_title(f"{title} (top, colored by z)")
    axes[0].set_aspect("equal")
    axes[1].scatter(c[:, 0], c[:, 2], s=0.2)
    axes[1].set_title("side profile (x-z)")
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="camera")
    p.add_argument("--pcl", required=True)
    p.add_argument("--n", type=int, default=4)
    p.add_argument("--out",
                   default=os.path.join(tempfile.gettempdir(),
                                        "augmentation_demo"))
    p.add_argument("--noise", action="store_true",
                   help="also inject triangular noise (needs a ground plane "
                        "estimate; a flat plane at -lidar_height is used)")
    args = p.parse_args(argv)

    from gndnet_tpu_torch.config import load_config
    from gndnet_tpu_torch.data.augmentation import AugmentationPipeline

    cfg = load_config(args.config)
    cloud = np.load(args.pcl).astype(np.float64)
    os.makedirs(args.out, exist_ok=True)
    render(os.path.join(args.out, "original.png"), cloud, "original")

    aug = AugmentationPipeline(cfg.augmentation, cfg.grid_range,
                               cfg.voxel_size)
    for i in range(args.n):
        sample = aug.augment_rotation(cloud[None].copy())
        sample, _ = aug.augment_height(sample)
        sample = sample[0]
        if args.noise and cloud.shape[1] >= 4:
            plane = np.full((cfg.nx, cfg.ny), -cfg.lidar_height)
            sample = aug.add_noise(sample, plane)
        out = os.path.join(args.out, f"augmented_{i}.png")
        render(out, sample, f"augmentation {i}")
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
