"""Synthetic kitti_sem-like scans, made from a numpy generator.

Used by `chip_smoke.py` and `gndnet_tpu_torch.profile_serve` on hosts that
have no recorded scans: a ground plane at -lidar_height (denser near the
sensor, as a spinning lidar sees it), box obstacles, a dense patch whose
cells hold more points than the per-cell cap, and points outside the
pc_range box.  `synthetic_labelled_batch` adds what training needs: a
sloped ground and its elevation at every cell, the label grid of the
reference's gnd_labels.
"""

from __future__ import annotations

import numpy as np


def synthetic_scan(cfg, rng, n: int = 100_000) -> np.ndarray:
    """A kitti_sem-like sensor-frame scan: a ground plane at -lidar_height,
    box obstacles, a dense patch whose cells hold more than the point cap,
    and points outside the pc_range box."""
    x0, y0, _, x1, y1, _ = cfg.pc_range
    pts = np.zeros((n, cfg.input_features), np.float32)
    n_ground, n_box, n_dense = int(n * 0.6), int(n * 0.25), int(n * 0.05)
    n_out = n - n_ground - n_box - n_dense
    # ground, denser near the sensor as a spinning lidar sees it
    r = np.abs(rng.normal(0, 18, n_ground)) + 2.0
    a = rng.uniform(-np.pi, np.pi, n_ground)
    g = np.stack([r * np.cos(a), r * np.sin(a),
                  -cfg.lidar_height + rng.normal(0, 0.03, n_ground)], 1)
    # boxes: 40 obstacles 1-4 m wide, up to 2 m tall
    centers = rng.uniform([x0 + 5, y0 + 5], [x1 - 5, y1 - 5], (40, 2))
    which = rng.integers(0, 40, n_box)
    half = rng.uniform(0.5, 2.0, (40, 2))[which]
    b = np.stack([centers[which, 0] + rng.uniform(-1, 1, n_box) * half[:, 0],
                  centers[which, 1] + rng.uniform(-1, 1, n_box) * half[:, 1],
                  -cfg.lidar_height + rng.uniform(0, 2.0, n_box)], 1)
    # a dense 3 m x 3 m patch: ~550 points per 1 m cell, over the cap of 100
    d = np.stack([rng.uniform(3, 6, n_dense), rng.uniform(-1.5, 1.5, n_dense),
                  -cfg.lidar_height + rng.uniform(0, 0.3, n_dense)], 1)
    # out of range: beyond the grid in xy, or far above it
    o = np.stack([rng.uniform(x1 + 1, x1 + 30, n_out),
                  rng.uniform(y0, y1, n_out), rng.uniform(-2, 2, n_out)], 1)
    o[::2, 0] = rng.uniform(x0, x1, o[::2, 0].shape)
    o[::2, 2] = rng.uniform(8, 20, o[::2, 2].shape)
    pts[:, :3] = np.concatenate([g, b, d, o])
    intensity = rng.uniform(0, 1, n)
    pts[:, 3:] = intensity[:, None]          # none for 3-feature configs
    return pts[rng.permutation(n)]


def synthetic_labelled_batch(cfg, rng, b: int, n: int = 100_000):
    """(points (b, n, F) float32, labels (b, ny, nx) float32): scans of
    `synthetic_scan`'s make whose ground is a random plane of slope up to
    3% per axis around -lidar_height, lifted with everything above it;
    labels[i, iy, ix] is that plane's height at the centre of cell (ix, iy)
    (the grid of `grid_range` and voxel_size)."""
    x0, y0 = cfg.grid_range[0], cfg.grid_range[1]
    vx, vy = cfg.voxel_size[0], cfg.voxel_size[1]
    cx = x0 + (np.arange(cfg.nx) + 0.5) * vx
    cy = y0 + (np.arange(cfg.ny) + 0.5) * vy
    points = np.empty((b, n, cfg.input_features), np.float32)
    labels = np.empty((b, cfg.ny, cfg.nx), np.float32)
    for i in range(b):
        sx, sy = rng.uniform(-0.03, 0.03, 2)
        scan = synthetic_scan(cfg, rng, n)
        scan[:, 2] += sx * scan[:, 0] + sy * scan[:, 1]
        points[i] = scan
        labels[i] = (-cfg.lidar_height + sx * cx[None, :]
                     + sy * cy[:, None])
    return points, labels
