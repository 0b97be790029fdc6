"""Host I/O shim: numpy-in / numpy-out adapters, ROS kept out of core.

The port's own copy of `gndnet_tpu.io_shim` (numpy only).

The reference entangles its core with ROS2 (ros2_numpy submodule, rclpy
imports inside utils, reference: utils/ros_utils.py, utils/utils.py:151-195).
Here the core speaks plain numpy; this module provides:

* PointCloud2 (de)serialization as pure byte-layout math — works on any
  object with `.data`, `.point_step`, `.fields` duck-typing, no rclpy needed
  (reference cloud_msg_to_numpy, utils/utils.py:151-195, and the raw-bytes
  fast publisher `array_to_pointcloud2`, utils/ros_utils.py:210-248);
* `shift_cloud` (reference utils/utils.py:137-139);
* cloud cropping/sampling used by the serving path
  (reference utils/utils.py:94-128);
* elevation-grid marker geometry (the line-list lattice the reference
  publishes for rviz, utils/ros_utils.py:43-120) computed as plain arrays so
  any viz backend can consume it.

The optional ROS2 node adapter lives in gndnet_tpu_torch/serving/ros_node.py
and is import-gated on rclpy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def shift_cloud(cloud: np.ndarray, height: float) -> np.ndarray:
    """Add `height` to z in place and return the cloud
    (reference utils/utils.py:137-139)."""
    cloud[:, 2] += height
    return cloud


def crop_cloud(cloud: np.ndarray, xy_range) -> np.ndarray:
    """Keep points with xmin <= x < xmax, ymin <= y < ymax.

    Axis-aligned replacement for the reference's Delaunay in_hull test on a
    rectangle (utils/utils.py:82-90 — a rectangle hull IS an AABB)."""
    xmin, ymin, xmax, ymax = xy_range
    m = ((cloud[:, 0] >= xmin) & (cloud[:, 0] < xmax)
         & (cloud[:, 1] >= ymin) & (cloud[:, 1] < ymax))
    return cloud[m]


def random_sample(cloud: np.ndarray, n: int, rng=None) -> np.ndarray:
    """Sample-with-replacement to exactly n rows; degenerate clouds produce
    ones like the reference (utils/utils.py:94-104)."""
    rng = rng or np.random.default_rng()
    if cloud.size == 0 or cloud.shape[0] <= 1:
        return np.ones((n, 3), np.float32)
    idx = rng.integers(0, cloud.shape[0], n)
    return cloud[idx]


def subsample_beams(cloud: np.ndarray, num_beams: int = 64,
                    keep_every: int = 2, phase: int = 0) -> np.ndarray:
    """Beam-ring decimation of a rotating-LiDAR cloud (BASELINE.md
    configuration #5: 32-beam sparse clouds).

    KITTI stores no ring index, so rings are recovered by binning each
    point's elevation angle into `num_beams` equal bins over the cloud's own
    elevation span (robust percentiles); keeping every `keep_every`-th ring
    turns a 64-beam sweep into a 32-beam-like sparse cloud.  No reference
    analog — the reference never exercises sparse-beam inputs."""
    xyz = cloud[:, :3]
    rng_xy = np.hypot(xyz[:, 0], xyz[:, 1])
    elev = np.arctan2(xyz[:, 2], np.maximum(rng_xy, 1e-6))
    lo, hi = np.percentile(elev, [0.5, 99.5])
    ring = np.clip(((elev - lo) / max(hi - lo, 1e-6) * num_beams)
                   .astype(np.int32), 0, num_beams - 1)
    return cloud[(ring % keep_every) == phase]


# ---------------------------------------------------------------------------
# PointCloud2 byte layout (no ROS dependency)
# ---------------------------------------------------------------------------

_DATATYPE_NP = {1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
                5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64}


@dataclass
class CloudField:
    name: str
    offset: int
    datatype: int = 7   # FLOAT32
    count: int = 1


def pointcloud2_to_numpy(data: bytes, point_step: int, fields) -> dict:
    """Decode a PointCloud2-layout byte buffer into {'xyz': (N,3) f32,
    'intensity': ..., 'rgb': ...} (reference cloud_msg_to_numpy,
    utils/utils.py:151-195).  `fields` is a list of CloudField or any object
    with .name/.offset/.datatype."""
    raw = np.frombuffer(data, np.uint8).reshape(-1, point_step)
    by_name = {f.name: f for f in fields}
    out = {}

    def column(field, dtype):
        o = field.offset
        w = np.dtype(dtype).itemsize
        return raw[:, o:o + w].copy().view(dtype).reshape(-1)

    if all(k in by_name for k in ("x", "y", "z")):
        out["xyz"] = np.stack(
            [column(by_name[k], _DATATYPE_NP[by_name[k].datatype])
             .astype(np.float32) for k in ("x", "y", "z")], axis=1)
    if "intensity" in by_name:
        f = by_name["intensity"]
        out["intensity"] = column(f, _DATATYPE_NP[f.datatype])
    if "rgb" in by_name:
        o = by_name["rgb"].offset
        out["rgb"] = raw[:, o:o + 3][:, ::-1].copy()
    return out


def numpy_to_pointcloud2(xyz: np.ndarray, intensity: np.ndarray | None = None,
                         rgb_labels: np.ndarray | None = None) -> dict:
    """Encode points into a PointCloud2-layout dict:
    {'data', 'point_step', 'fields', 'width', 'height'}.

    Matches the reference's raw-bytes publisher layout
    (array_to_pointcloud2, utils/ros_utils.py:210-248): float32 x,y,z
    [+ intensity] [+ rgb packed from a {-1,0,1} segmentation label like
    np2ros_pub_2's green/red coloring, utils/ros_utils.py:149-176].
    A ROS adapter can pour these straight into a sensor_msgs/PointCloud2."""
    n = xyz.shape[0]
    cols = [xyz[:, 0], xyz[:, 1], xyz[:, 2]]
    fields = [CloudField("x", 0), CloudField("y", 4), CloudField("z", 8)]
    off = 12
    if intensity is not None:
        cols.append(intensity.astype(np.float32))
        fields.append(CloudField("intensity", off))
        off += 4
    if rgb_labels is not None:
        # obstacle (1) -> red, ground (0) -> green, outside (-1) -> blue
        lab = np.asarray(rgb_labels)
        r = (lab == 1).astype(np.uint32)
        g = (lab == 0).astype(np.uint32)
        b = (lab == -1).astype(np.uint32)
        packed = (r * 255 << 16) | (g * 255 << 8) | (b * 255)
        cols.append(packed.view(np.float32))
        fields.append(CloudField("rgb", off))
        off += 4
    arr = np.stack([c.astype(np.float32, copy=False) for c in cols[:3]]
                   + [c for c in cols[3:]], axis=1).astype(np.float32)
    return {
        "data": arr.tobytes(),
        "point_step": off,
        "fields": fields,
        "width": n,
        "height": 1,
    }


def elevation_grid_lines(elevation: np.ndarray, cfg, decimate: int = 4):
    """Line-list vertex pairs tracing the predicted elevation lattice.

    Pure-geometry equivalent of the reference's rviz Marker publisher
    (gnd_marker_pub, utils/ros_utils.py:43-120): every `decimate`-th grid node
    connected to its +x and +y neighbours.  Returns (L, 2, 3) float32 segment
    endpoints in world coordinates; color/publishing is the adapter's job."""
    ny, nx = elevation.shape
    xmin, ymin = cfg.grid_range[0], cfg.grid_range[1]
    cell = cfg.voxel_size[0]
    ys, xs = np.meshgrid(np.arange(0, ny, decimate),
                         np.arange(0, nx, decimate), indexing="ij")
    px = xmin + xs * cell
    py = ymin + ys * cell
    pz = elevation[ys, xs]
    pts = np.stack([px, py, pz], axis=-1)           # (gy, gx, 3)
    segs = []
    if pts.shape[1] > 1:
        a = pts[:, :-1].reshape(-1, 3)
        b = pts[:, 1:].reshape(-1, 3)
        segs.append(np.stack([a, b], axis=1))
    if pts.shape[0] > 1:
        a = pts[:-1, :].reshape(-1, 3)
        b = pts[1:, :].reshape(-1, 3)
        segs.append(np.stack([a, b], axis=1))
    return (np.concatenate(segs).astype(np.float32)
            if segs else np.zeros((0, 2, 3), np.float32))
