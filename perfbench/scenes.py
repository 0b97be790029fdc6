"""Synthetic LiDAR scenes, made on the host from a numpy generator.

A frozen copy of `gndnet_tpu_torch.synthetic`'s `synthetic_scan` and
`synthetic_labelled_batch`, kept here so that a change to the program
cannot move the benchmark's inputs, plus `camera_scan`: the same kind of
scene drawn inside a camera configuration's field-of-view extract (the
kitti scene is centred on the sensor and would leave that box nearly
empty).

A scene has a ground plane at -lidar_height (denser near the sensor, as a
spinning lidar sees it), box obstacles, a dense patch whose cells hold
more points than the per-cell cap, and points outside the pc_range box,
in a random order.  The functions take any object with the fields of a
`GndNetConfig` that they read.
"""

from __future__ import annotations

import numpy as np


def kitti_scan(cfg, rng, n: int) -> np.ndarray:
    """A kitti_sem-like sensor-frame scan of n points: ground (60%), 40
    boxes 1-4 m wide and up to 2 m tall (25%), a dense 3 m x 3 m patch of
    about 550 points a 1 m cell (5%), out of range (10%)."""
    x0, y0, _, x1, y1, _ = cfg.pc_range
    pts = np.zeros((n, cfg.input_features), np.float32)
    n_ground, n_box, n_dense = int(n * 0.6), int(n * 0.25), int(n * 0.05)
    n_out = n - n_ground - n_box - n_dense
    r = np.abs(rng.normal(0, 18, n_ground)) + 2.0
    a = rng.uniform(-np.pi, np.pi, n_ground)
    g = np.stack([r * np.cos(a), r * np.sin(a),
                  -cfg.lidar_height + rng.normal(0, 0.03, n_ground)], 1)
    centers = rng.uniform([x0 + 5, y0 + 5], [x1 - 5, y1 - 5], (40, 2))
    which = rng.integers(0, 40, n_box)
    half = rng.uniform(0.5, 2.0, (40, 2))[which]
    b = np.stack([centers[which, 0] + rng.uniform(-1, 1, n_box) * half[:, 0],
                  centers[which, 1] + rng.uniform(-1, 1, n_box) * half[:, 1],
                  -cfg.lidar_height + rng.uniform(0, 2.0, n_box)], 1)
    d = np.stack([rng.uniform(3, 6, n_dense), rng.uniform(-1.5, 1.5, n_dense),
                  -cfg.lidar_height + rng.uniform(0, 0.3, n_dense)], 1)
    o = np.stack([rng.uniform(x1 + 1, x1 + 30, n_out),
                  rng.uniform(y0, y1, n_out), rng.uniform(-2, 2, n_out)], 1)
    o[::2, 0] = rng.uniform(x0, x1, o[::2, 0].shape)
    o[::2, 2] = rng.uniform(8, 20, o[::2, 2].shape)
    return _finish(pts, [g, b, d, o], rng)


def camera_scan(cfg, rng, n: int) -> np.ndarray:
    """A scene inside a camera extract's box (pc_range x0..x1, y0..y1):
    ground denser near the sensor (60%), 6 boxes 0.3-1.2 m wide and up to
    2 m tall (25%), a dense 0.4 m x 0.4 m patch of about 125 points a
    0.2 m cell (5%, over the cap of 100), out of range (10%: past the far
    edge, or far above the ground)."""
    x0, y0, _, x1, y1, _ = cfg.pc_range
    pts = np.zeros((n, cfg.input_features), np.float32)
    n_ground, n_box, n_dense = int(n * 0.6), int(n * 0.25), int(n * 0.05)
    n_out = n - n_ground - n_box - n_dense
    span = x1 - x0
    gx = np.minimum(x0 + np.abs(rng.normal(0, 0.45 * span, n_ground)),
                    x1 - 1e-3)
    g = np.stack([gx, rng.uniform(y0, y1, n_ground),
                  -cfg.lidar_height + rng.normal(0, 0.03, n_ground)], 1)
    centers = rng.uniform([x0 + 1, y0 + 1], [x1 - 1, y1 - 1], (6, 2))
    which = rng.integers(0, 6, n_box)
    half = rng.uniform(0.15, 0.6, (6, 2))[which]
    b = np.stack([centers[which, 0] + rng.uniform(-1, 1, n_box) * half[:, 0],
                  centers[which, 1] + rng.uniform(-1, 1, n_box) * half[:, 1],
                  -cfg.lidar_height + rng.uniform(0, 2.0, n_box)], 1)
    cx, cy = x0 + 0.3 * span, 0.5 * (y0 + y1)
    d = np.stack([rng.uniform(cx, cx + 0.4, n_dense),
                  rng.uniform(cy, cy + 0.4, n_dense),
                  -cfg.lidar_height + rng.uniform(0, 0.3, n_dense)], 1)
    o = np.stack([rng.uniform(x1 + 0.5, x1 + 10, n_out),
                  rng.uniform(y0, y1, n_out), rng.uniform(-2, 2, n_out)], 1)
    o[::2, 0] = rng.uniform(x0, x1, o[::2, 0].shape)
    o[::2, 2] = rng.uniform(8, 20, o[::2, 2].shape)
    return _finish(pts, [g, b, d, o], rng)


def _finish(pts: np.ndarray, parts: list, rng) -> np.ndarray:
    """xyz from the parts, a uniform intensity in any 4th column, and a
    random order."""
    n = pts.shape[0]
    pts[:, :3] = np.concatenate(parts)
    pts[:, 3:] = rng.uniform(0, 1, n)[:, None]
    return pts[rng.permutation(n)]


SCENES = {"kitti": kitti_scan, "camera": camera_scan}


def scene(kind: str, cfg, rng, n: int) -> np.ndarray:
    """One scene of `kind` (a key of SCENES)."""
    return SCENES[kind](cfg, rng, n)


def labelled_batch(kind: str, cfg, rng, b: int, n: int):
    """(points (b, n, F) float32, labels (b, ny, nx) float32): scenes of
    `kind` whose ground is a random plane of slope up to 3% per axis
    around -lidar_height, lifted with everything above it; labels[i, iy,
    ix] is that plane's height at the centre of cell (ix, iy) of the
    grid_range grid."""
    x0, y0 = cfg.grid_range[0], cfg.grid_range[1]
    vx, vy = cfg.voxel_size[0], cfg.voxel_size[1]
    cx = x0 + (np.arange(cfg.nx) + 0.5) * vx
    cy = y0 + (np.arange(cfg.ny) + 0.5) * vy
    points = np.empty((b, n, cfg.input_features), np.float32)
    labels = np.empty((b, cfg.ny, cfg.nx), np.float32)
    for i in range(b):
        sx, sy = rng.uniform(-0.03, 0.03, 2)
        s = scene(kind, cfg, rng, n)
        s[:, 2] += sx * s[:, 0] + sy * s[:, 1]
        points[i] = s
        labels[i] = -cfg.lidar_height + sx * cx[None, :] + sy * cy[:, None]
    return points, labels
