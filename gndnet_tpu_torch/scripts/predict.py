"""Single-scan inference CLI.

Counterpart of `scripts/predict.py` (the reference's predict_ground.py:
51-62): load a cloud (.npy or KITTI .bin), run the engine, print its
counts and elevation range, optionally save the elevation map and the
segmentation and a PNG view.

Example:
  python -m gndnet_tpu_torch.scripts.predict --config kitti_sem \\
      --pcl scan.npy --resume checkpoint.pth.tar --out out_prefix \\
      [--device cpu]
"""

import argparse

import numpy as np


def load_cloud(path: str, num_features: int, lidar_height: float,
               shift_cloud: bool) -> np.ndarray:
    """The reference's input semantics (predict_ground.py:124-135): .npy
    files are generated reduced_velo data stored already shifted by
    lidar_height, so they are un-shifted here (the engine adds it again);
    .bin raw scans pass through; missing feature columns are padded with
    ones."""
    if path.endswith(".bin"):
        pts = np.fromfile(path, np.float32).reshape(-1, 4)
    else:
        pts = np.load(path).astype(np.float32)
        if shift_cloud:
            pts[:, 2] -= lidar_height
    if pts.shape[1] < num_features:
        pts = np.concatenate(
            [pts, np.ones((len(pts), num_features - pts.shape[1]),
                          np.float32)], 1)
    return pts[:, :num_features]


def save_visualization(path, cfg, cloud, elevation, labels):
    """A matplotlib stand-in for the reference's rviz view
    (predict_ground.py -v): the elevation map and the segmented cloud from
    above."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(14, 6))
    im = axes[0].imshow(elevation, origin="lower",
                        extent=(cfg.pc_range[0], cfg.pc_range[3],
                                cfg.pc_range[1], cfg.pc_range[4]))
    axes[0].set_title("predicted ground elevation")
    fig.colorbar(im, ax=axes[0], shrink=0.8)

    colors = {1: "tab:red", 0: "tab:green", -1: "tab:gray"}
    names = {1: "obstacle", 0: "ground", -1: "outside"}
    step = max(1, len(cloud) // 40000)
    for lab in (0, 1, -1):
        m = labels[::step] == lab
        axes[1].scatter(cloud[::step][m, 0], cloud[::step][m, 1], s=0.3,
                        c=colors[lab], label=names[lab])
    axes[1].set_title("per-point segmentation (top view)")
    axes[1].set_aspect("equal")
    axes[1].legend(markerscale=20)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="kitti_sem")
    p.add_argument("--pcl", required=True, help=".npy or KITTI .bin cloud")
    p.add_argument("--resume", default="", help="checkpoint: a .pth.tar "
                   "(reference format) or a CheckpointManager directory")
    p.add_argument("--threshold", type=float, default=0.08,
                   help="segmentation threshold (reference default 0.08)")
    p.add_argument("--out", default="", help="save <out>_elevation.npy and "
                   "<out>_segmentation.npy")
    p.add_argument("--viz", default="", help="save a PNG visualization "
                   "(elevation map + segmented scatter) to this path")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    from gndnet_tpu_torch.checkpoint import load_weights
    from gndnet_tpu_torch.config import load_config
    from gndnet_tpu_torch.infer import GroundInferenceEngine
    from gndnet_tpu_torch.weights import init_state_dict

    cfg = load_config(args.config)
    state_dict = (load_weights(args.resume, cfg) if args.resume
                  else init_state_dict(cfg))
    engine = GroundInferenceEngine(cfg, state_dict, threshold=args.threshold,
                                   device=args.device)
    cloud = load_cloud(args.pcl, cfg.input_features, cfg.lidar_height,
                       cfg.shift_cloud)
    elevation, labels = engine.infer(cloud)
    n_gnd = int((labels == 0).sum())
    n_obs = int((labels == 1).sum())
    n_out = int((labels == -1).sum())
    print(f"points: {len(cloud)}  ground: {n_gnd}  obstacle: {n_obs}  "
          f"outside: {n_out}")
    print(f"elevation: shape {elevation.shape}  "
          f"range [{elevation.min():.3f}, {elevation.max():.3f}]")
    if args.out:
        np.save(args.out + "_elevation.npy", elevation)
        np.save(args.out + "_segmentation.npy", labels)
        print(f"saved {args.out}_elevation.npy / _segmentation.npy")
    if args.viz:
        save_visualization(args.viz, cfg, cloud, elevation, labels)
        print(f"saved {args.viz}")
    return elevation, labels


if __name__ == "__main__":
    main()
