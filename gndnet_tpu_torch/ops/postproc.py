"""Post-processing ops: threshold segmentation, occupancy and height maps,
frustum culling.

Counterpart of `gndnet_tpu.ops.postproc` (reference utils/utils.py:198-295,
dataset_generator_utils.py:146-232, frustrum_culling.py:23-102), keeping
the reference's quirks where they are semantics:

* the `0 < idx` lower bound, which excludes grid row and column 0
  (utils/utils.py:213), in `segment_cloud`, `lidar_to_img` and the
  evaluation heightmap;
* `lidar_to_heightmap` in two variants: the corrected generator one
  (`0 <= idx`, mean over the kept count) and, with
  `reference_eval_bug=True`, the evaluation one (`0 < idx`, sum divided by
  count + 1, utils/utils.py:283-295), on which the published MSE depends.

The functions take and return tensors on the caller's device; the frustum
planes stay numpy float64 on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from gndnet_tpu_torch.ops.pillarize import exact_div, stream_ranks


def _cell_indices(points: torch.Tensor, grid_range, cell_size: float):
    """floor((xy - grid_min) / cell) as int32 (reference utils.py:204-207)."""
    ix = torch.floor(exact_div(points[..., 0] - grid_range[0], cell_size))
    iy = torch.floor(exact_div(points[..., 1] - grid_range[1], cell_size))
    return ix.to(torch.int32), iy.to(torch.int32)


def _grid_shape(grid_range, cell_size: float, out_shape) -> tuple:
    if out_shape is not None:
        return tuple(out_shape)
    return (int(round((grid_range[2] - grid_range[0]) / cell_size)),
            int(round((grid_range[3] - grid_range[1]) / cell_size)))


def segment_cloud(points: torch.Tensor, grid_range, cell_size: float,
                  elevation_map: torch.Tensor,
                  threshold: float = 0.2) -> torch.Tensor:
    """Per-point {1: obstacle, 0: ground, -1: out of grid} float32 labels.

    `elevation_map` is indexed [x_cell, y_cell], i.e. the transposed model
    output (reference predict_ground.py:168 passes pred_gnd.T).  Leading
    dimensions batch: points (..., N, F) against maps (..., h, w) label
    each scan against its own map in one gather (the JAX engine's
    `vmap(segment_cloud)`)."""
    ix, iy = _cell_indices(points, grid_range, cell_size)
    h, w = elevation_map.shape[-2:]
    inside = (ix > 0) & (ix < h) & (iy > 0) & (iy < w)
    flat = ix.clamp(0, h - 1).long() * w + iy.clamp(0, w - 1).long()
    elev = elevation_map.reshape(*elevation_map.shape[:-2], h * w).gather(
        -1, flat)
    obstacle = points[..., 2] > elev + threshold
    return torch.where(inside, obstacle.float(), -1.0)


def segment_cloud_masked(points: torch.Tensor, grid_range, cell_size: float,
                         elevation_map: torch.Tensor,
                         threshold: float = 0.2) -> tuple:
    """`segment_cloud` plus the obstacle mask (labels == 1), so a caller
    can compact an obstacle-only cloud without a second pass (the
    reference's in-place compaction, utils/utils.py:222-248, whose copy
    from `points_obstacle[i]` is a bug not reproduced)."""
    labels = segment_cloud(points, grid_range, cell_size, elevation_map,
                           threshold)
    return labels, labels == 1.0


def compact_obstacles(points: torch.Tensor,
                      obstacle_mask: torch.Tensor) -> tuple:
    """Stable-compact obstacle points to the front: (cloud, count) with
    zeros past `count` (a 0-d int32 tensor), the fixed-shape form of the
    reference's dynamic obstacle cloud."""
    order = torch.argsort((~obstacle_mask).to(torch.uint8), stable=True)
    count = obstacle_mask.sum(dtype=torch.int32)
    rows = torch.arange(points.shape[0], device=points.device)[:, None]
    return torch.where(rows < count, points[order], 0), count


def lidar_to_img(points: torch.Tensor, grid_range, cell_size: float,
                 fill: float = 1.0, lidar_height: float = 0.0,
                 out_shape=None) -> torch.Tensor:
    """(h, w) float32 occupancy image: cells touched by a point with
    z + lidar_height < 10 get `fill` (reference utils/utils.py:250-268, its
    hard-coded +1.732 generalised to `lidar_height`; the quirky 0 < idx
    bounds).  Points that miss write into a drop slot past the grid."""
    h, w = _grid_shape(grid_range, cell_size, out_shape)
    ix, iy = _cell_indices(points, grid_range, cell_size)
    z = points[:, 2] + lidar_height
    ok = (z < 10) & (ix > 0) & (ix < h) & (iy > 0) & (iy < w)
    flat = torch.where(ok, ix * w + iy, h * w).long()
    img = torch.zeros(h * w + 1, dtype=torch.float32, device=points.device)
    img[flat] = fill
    return img[:h * w].reshape(h, w)


def lidar_to_heightmap(points: torch.Tensor, grid_range, cell_size: float,
                       max_points: int = 100, lidar_height: float = 0.0,
                       reference_eval_bug: bool = False,
                       out_shape=None) -> tuple:
    """(heightmap (h, w) float32, counts (h, w) int32): the mean z (plus
    `lidar_height`) per cell over the first `max_points` points of the
    cell in stream order, among points with z + lidar_height < 10.

    The default is the corrected generator variant
    (dataset_generator_utils.py:167-192): 0 <= idx bounds, divided by the
    kept count (0 in an empty cell).  `reference_eval_bug=True` is the
    evaluation variant (utils/utils.py:271-295): 0 < idx bounds and
    sum / (count + 1)."""
    h, w = _grid_shape(grid_range, cell_size, out_shape)
    ix, iy = _cell_indices(points, grid_range, cell_size)
    z = points[:, 2] + lidar_height
    if reference_eval_bug:
        inside = (ix > 0) & (ix < h) & (iy > 0) & (iy < w)
    else:
        inside = (ix >= 0) & (ix < h) & (iy >= 0) & (iy < w)
    ok = (z < 10) & inside
    flat = torch.where(ok, ix * w + iy, h * w)
    kept = ok & (stream_ranks(flat) < max_points)
    flat_kept = torch.where(kept, flat, h * w).long()
    sums = torch.zeros(h * w + 1, dtype=torch.float32, device=points.device)
    sums.index_add_(0, flat_kept, torch.where(kept, z, 0.0))
    counts = torch.zeros(h * w + 1, dtype=torch.int32, device=points.device)
    counts.index_add_(0, flat_kept, kept.to(torch.int32))
    sums, counts = sums[:h * w], counts[:h * w]
    if reference_eval_bug:
        hm = sums / (counts.float() + 1.0)
    else:
        hm = torch.where(counts > 0, sums / counts.clamp(min=1), 0.0)
    return hm.reshape(h, w), counts.reshape(h, w)


def semantically_segment_cloud(points: torch.Tensor, grid_range,
                               cell_size: float,
                               elevation_map: torch.Tensor,
                               lidar_height: float,
                               threshold: float = 0.08) -> torch.Tensor:
    """(N, 3) rgb-style float32 labels, channel 0 = {1, 0, -1}, of the
    cloud shifted up by `lidar_height` against `elevation_map` [x, y]
    (reference dataset_generator_utils.py:209-232).  The JAX function
    shifts only a jax array, which is what its generator passes; the port
    always shifts."""
    shifted = points.clone()
    shifted[:, 2] += lidar_height
    labels = segment_cloud(shifted, grid_range, cell_size, elevation_map,
                           threshold)
    rgb = torch.zeros((points.shape[0], 3), dtype=torch.float32,
                      device=points.device)
    rgb[:, 0] = labels
    return rgb


def remove_outliers(pred_seg: torch.Tensor, gt_seg: torch.Tensor) -> tuple:
    """Joint validity mask for the metrics: keep points labelled in both
    segmentations, inverted so ground == 1 (reference
    evaluate_SemanticKITTI.py:102-111).  Returns (pred_ground, gt_ground,
    valid) with invalid rows zeroed."""
    valid = (pred_seg >= 0) & (gt_seg >= 0)
    return (torch.where(valid, 1.0 - pred_seg, 0.0),
            torch.where(valid, 1.0 - gt_seg, 0.0), valid)


# ---------------------------------------------------------------------------
# frustum culling (vectorised plane tests)
# ---------------------------------------------------------------------------

def frustum_planes(observer_position, observer_direction, fov_degrees,
                   near_clip, far_clip, aspect_ratio=1.0) -> tuple:
    """Six frustum planes as numpy float64 (origins (6, 3), normals
    (6, 3)) in the order near, far, top, right, bottom, left; the
    reference's basis (frustrum_culling.py:24-67)."""
    pos = np.asarray(observer_position, np.float64)
    fwd = np.asarray(observer_direction, np.float64)
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross([0.0, 0.0, -1.0], fwd)
    up = -np.cross(fwd, right)
    fov = np.radians(fov_degrees)

    nc = pos + fwd * near_clip
    fc = pos + fwd * far_clip
    nh = np.tan(fov / 2) * near_clip
    nw = nh * aspect_ratio
    fh = np.tan(fov / 2) * far_clip
    fw = fh * aspect_ratio

    ntl = nc + up * nh - right * nw
    ntr = nc + up * nh + right * nw
    nbl = nc - up * nh - right * nw
    nbr = nc - up * nh + right * nw
    ftl = fc + up * fh - right * fw
    ftr = fc + up * fh + right * fw
    fbl = fc - up * fh - right * fw
    fbr = fc - up * fh + right * fw

    planes = [
        (ntl, ntr, nbl),   # near
        (ftr, ftl, fbr),   # far
        (ntl, ftl, ftr),   # top
        (ntr, ftr, fbr),   # right
        (nbr, fbr, fbl),   # bottom
        (nbl, fbl, ftl),   # left
    ]
    origins, normals = [], []
    for p0, p1, p2 in planes:
        n = np.cross(p1 - p0, p2 - p0)
        origins.append(p0)
        normals.append(n / np.linalg.norm(n))
    return np.stack(origins), np.stack(normals)


def filter_points_by_frustum(points: torch.Tensor, observer_position,
                             observer_direction, fov, aspect_ratio, near,
                             far) -> torch.Tensor:
    """(N,) bool inside-frustum mask of (N, >=3) points: one (N, 6) dot
    product in the points' dtype instead of the reference's per-point loop
    (frustrum_culling.py:92-102)."""
    origins, normals = frustum_planes(
        observer_position, observer_direction, fov, near, far, aspect_ratio)
    o = torch.as_tensor(origins, dtype=points.dtype, device=points.device)
    n = torch.as_tensor(normals, dtype=points.dtype, device=points.device)
    d = torch.einsum("npk,pk->np", points[:, None, :3] - o[None], n)
    return (d >= 0).all(dim=1)
