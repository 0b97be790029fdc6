"""Point-cloud augmentation: the host pipeline (numpy) and the train-time
one on the device (torch).

Counterpart of `gndnet_tpu.data.augmentation` (reference
dataset_utils/gnd_data_generator/dataset_augmentation.py:8-240):

* batched random rotations with independent limits for front slope (about
  y), side tilt and yaw, as euler 'zyx' degrees through scipy's Rotation
  (dataset_augmentation.py:141-154);
* a random height shift (:156-158);
* the ground truth transformed with the cloud: each cell's coordinate is
  rotated with its elevation (:192-218; the reference's
  `augmentHeightWithGroundTruth` names an undefined `labels`, :220-223,
  which is repaired here);
* triangular-profile noise labelled class 260 above and below the ground
  (:72-139);
* camera field-of-view culling through `ops.postproc`'s frustum filter.

`AugmentationPipeline` draws from an explicit `np.random.Generator`, so the
same seed gives the JAX package's arrays.  On the device the draw and the
transform are separate: `augment_draws` takes the angles and height shifts
from a `torch.Generator`, and `apply_augment` is the deterministic rotation,
shift and label transform, with no host sync.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gndnet_tpu_torch.config import AugmentationConfig, GndNetConfig
from gndnet_tpu_torch.ops.postproc import filter_points_by_frustum

NOISE_CLASS = 260  # the reference labels injected noise as 260


# ---------------------------------------------------------------------------
# host pipeline (data generation)
# ---------------------------------------------------------------------------

class AugmentationPipeline:
    def __init__(self, cfg: AugmentationConfig, grid_range, voxel_size,
                 rng: np.random.Generator | None = None):
        self.cfg = cfg
        self.grid_range = np.asarray(grid_range, np.float64)
        self.cell = (float(voxel_size[0]) if np.ndim(voxel_size)
                     else float(voxel_size))
        self.rng = rng or np.random.default_rng()

    # -- rotations -----------------------------------------------------------

    def _random_rotations(self, n):
        from scipy.spatial.transform import Rotation as R

        theta = np.array([self.cfg.max_rotation, self.cfg.max_side_tilt,
                          self.cfg.max_front_slope])
        angles = theta * (2 * self.rng.random((n, 3)) - 1)
        return R.from_euler("zyx", angles, degrees=True).as_matrix()

    def augment_rotation(self, data: np.ndarray) -> np.ndarray:
        """data: (B, N, >=3); rotates xyz in place and returns data."""
        rots = self._random_rotations(data.shape[0])
        data[:, :, :3] = np.einsum("bnk,bjk->bnj", data[:, :, :3], rots)
        return data

    def augment_rotation_with_gt(self, data: np.ndarray, labels: np.ndarray):
        """Rotate clouds and their (H, W) elevation grids together: each
        cell coordinate `indices * scale + offset` (the reference's cell
        corners, dataset_augmentation.py:202-218) with its elevation is
        rotated, and the z column kept."""
        rots = self._random_rotations(data.shape[0])
        data[:, :, :3] = np.einsum("bnk,bjk->bnj", data[:, :, :3], rots)

        shape = np.asarray(labels[0].shape)
        offset = self.grid_range[0:2]
        scale = (self.grid_range[2:4] - self.grid_range[0:2]) / shape
        idx = np.indices(labels[0].shape).T.reshape(-1, 2)
        coords = idx * scale + offset                      # (H*W, 2)
        for i in range(data.shape[0]):
            g = np.concatenate(
                [coords, labels[i].reshape(1, -1).T], axis=1)  # (H*W, 3)
            labels[i] = (g @ rots[i].T)[:, 2].reshape(labels[i].shape)
        return data, labels

    # -- height --------------------------------------------------------------

    def augment_height(self, data: np.ndarray,
                       labels: np.ndarray | None = None):
        dz = self.cfg.max_height * (2 * self.rng.random(data.shape[0]) - 1)
        data[:, :, 2] += dz[:, None]
        if labels is not None:
            labels += dz[:, None, None]
        return data, labels

    # -- batch expansion (reference getAugmentedData) -------------------------

    def augment_batch(self, data: np.ndarray,
                      labels: np.ndarray | None = None):
        """Expand a (B, N, F) batch by num_rotations / num_height_var /
        keep_original (reference dataset_augmentation.py:49-70, 160-190)."""
        cfg = self.cfg
        out = data if not cfg.keep_original else np.copy(data)
        lab = labels if (labels is None or not cfg.keep_original) \
            else np.copy(labels)
        if cfg.num_rotations > 0:
            if cfg.num_rotations > 1:
                out = np.repeat(out, cfg.num_rotations, axis=0)
                if lab is not None:
                    lab = np.repeat(lab, cfg.num_rotations, axis=0)
            if lab is None:
                out = self.augment_rotation(out)
            else:
                out, lab = self.augment_rotation_with_gt(out, lab)
        if cfg.num_height_var > 0:
            if cfg.num_height_var > 1:
                out = np.repeat(out, cfg.num_height_var, axis=0)
                if lab is not None:
                    lab = np.repeat(lab, cfg.num_height_var, axis=0)
            out, lab = self.augment_height(out, lab)
        if cfg.keep_original:
            out = np.concatenate([data, out])
            if lab is not None:
                lab = np.concatenate([labels, lab])
        return (out, lab) if labels is not None else out

    # -- noise injection -------------------------------------------------------

    def add_noise(self, data: np.ndarray, gnd_plane: np.ndarray) -> np.ndarray:
        """Inject triangular-profile noise points labelled NOISE_CLASS.

        data: (N, >=4) one cloud with its class in column 3; gnd_plane:
        (H, W) elevation grid over grid_range.  The count scales with a
        random density over the triangular side-profile volume; points lie
        above (+) and below (-) the ground with a spread that grows with
        distance (reference _addNoise, dataset_augmentation.py:75-139)."""
        cfg = self.cfg
        rng = self.rng
        lo = np.maximum(data[:, :2].min(axis=0), self.grid_range[:2])
        hi = np.minimum(data[:, :2].max(axis=0), self.grid_range[2:4])

        min_distance = rng.random() * (
            cfg.noise_min_distance[1] - cfg.noise_min_distance[0]
        ) + cfg.noise_min_distance[0]
        x0 = max(lo[0], min_distance)
        x1 = hi[0]
        if x0 >= x1:
            return data

        chunks = [data]
        for side, (coeffs, densities) in enumerate(
            [(cfg.noise_coefficient_top, cfg.noise_density_top),
             (cfg.noise_coefficient_bottom, cfg.noise_density_bottom)]
        ):
            if coeffs[0] == 0 and coeffs[1] == 0:
                continue
            coeff = rng.random() * (coeffs[1] - coeffs[0]) + coeffs[0]
            dens = rng.random() * (densities[1] - densities[0]) + densities[0]
            area = 0.5 * (x1 - x0) * x1 * coeff
            count = int(area * (hi[1] - lo[1]) * dens * 0.01)
            if count <= 0:
                continue
            pts = np.zeros((count, data.shape[1]), data.dtype)
            pts[:, 0] = rng.random(count) * (x1 - x0) + x0
            pts[:, 1] = rng.random(count) * (hi[1] - lo[1]) + lo[1]
            gi = np.clip(
                ((pts[:, :2] - self.grid_range[:2]) / self.cell).astype(int),
                0, np.asarray(gnd_plane.shape) - 1)
            spread = np.abs(rng.normal(
                0.0, (pts[:, 0] - x0 + 1e-6) * coeff))
            sign = 1.0 if side == 0 else -1.0
            pts[:, 2] = gnd_plane[gi[:, 0], gi[:, 1]] + sign * spread
            if data.shape[1] > 3:
                pts[:, 3] = NOISE_CLASS
            chunks.append(pts)
        return np.concatenate(chunks)

    # -- FOV -------------------------------------------------------------------

    def camera_fov(self, data: np.ndarray, fov=115.0, aspect_ratio=16 / 9,
                   near=0.1, far=10.0) -> np.ndarray:
        """Frustum-cull to a forward camera's field of view (reference
        getCameraFOV, dataset_augmentation.py:225-240), on the host."""
        mask = filter_points_by_frustum(
            torch.from_numpy(data[:, :3].astype(np.float32)),
            np.zeros(3, np.float32), np.array([1.0, 0, 0], np.float32),
            fov, aspect_ratio, near, far).numpy()
        return data[mask]


# ---------------------------------------------------------------------------
# on the device (train time)
# ---------------------------------------------------------------------------

def augment_generator(seed: int, step: int, device,
                      rank: int | None = None) -> torch.Generator:
    """A generator on `device` seeded from (seed, step), so every optimizer
    step draws anew and the same step draws the same (the JAX package
    keys its step on fold_in(PRNGKey(0), step)); with a data-parallel
    `rank`, from (seed, step, rank), so each shard draws its own (the
    mesh steps' fold_in of the dp index)."""
    entropy = (seed, step) if rank is None else (seed, step, rank)
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence(entropy)
                      .generate_state(1, np.uint64)[0]))
    return g


def augment_draws(generator: torch.Generator, b: int,
                  cfg: GndNetConfig) -> tuple:
    """(angles (b, 3) float32 radians [yaw, tilt, slope], dz (b,) float32):
    each uniform in [-1, 1) times its limit, on the generator's device."""
    a = cfg.augmentation
    dev = generator.device
    u = torch.rand((b, 3), generator=generator, device=dev) * 2 - 1
    deg = np.float32(math.pi / 180.0)
    ang = torch.stack([u[:, i] * float(np.float32(m) * deg) for i, m in
                       enumerate((a.max_rotation, a.max_side_tilt,
                                  a.max_front_slope))], 1)
    dz = (torch.rand((b,), generator=generator, device=dev) * 2 - 1
          ) * a.max_height
    return ang, dz


def euler_zyx_matrices(angles: torch.Tensor) -> torch.Tensor:
    """(b, 3, 3) rotation matrices of euler angles (b, 3) in radians
    [yaw, tilt, slope]: R = Rz @ Ry @ Rx, the JAX package's
    `_euler_zyx_matrices`.  That is scipy's intrinsic
    R.from_euler('ZYX'); the host pipeline's extrinsic 'zyx' composes
    Rx @ Ry @ Rz."""
    cz, sz = torch.cos(angles[:, 0]), torch.sin(angles[:, 0])
    cy, sy = torch.cos(angles[:, 1]), torch.sin(angles[:, 1])
    cx, sx = torch.cos(angles[:, 2]), torch.sin(angles[:, 2])
    zero, one = torch.zeros_like(cz), torch.ones_like(cz)
    rz = torch.stack([cz, -sz, zero, sz, cz, zero, zero, zero, one],
                     -1).reshape(-1, 3, 3)
    ry = torch.stack([cy, zero, sy, zero, one, zero, -sy, zero, cy],
                     -1).reshape(-1, 3, 3)
    rx = torch.stack([one, zero, zero, zero, cx, -sx, zero, sx, cx],
                     -1).reshape(-1, 3, 3)
    return _matmul(_matmul(rz, ry), rx)


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., i, k) @ (..., k, j) as float32 products and sums (no TF32)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def apply_augment(points: torch.Tensor, labels: torch.Tensor,
                  rots: torch.Tensor, dz: torch.Tensor,
                  cfg: GndNetConfig) -> tuple:
    """Rotate (B, N, F) points by `rots` (B, 3, 3), shift z by `dz` (B,),
    and transform their (B, H, W) label grids alike (the JAX package's
    `device_augment` given its draws).

    Labels are stored [y_cell, x_cell] (the generator saves the transposed
    [x, y] heightmap, reference semKitti_morph_data_camera.py:287-310), so
    cell (iy, ix) sits at world (x = xmin + ix * sx, y = ymin + iy * sy),
    sx from the width and sy from the height; each cell's (x, y, z) is
    rotated and its z kept."""
    b = points.shape[0]
    h, w = labels.shape[1:]
    gr = cfg.grid_range
    xyz = (points[..., None, :3] * rots[:, None]).sum(-1)
    z = xyz[..., 2] + dz[:, None]
    points = torch.cat([xyz[..., :2], z[..., None], points[..., 3:]], -1)

    dev = labels.device
    sx = (np.float32(gr[2]) - np.float32(gr[0])) / np.float32(w)
    sy = (np.float32(gr[3]) - np.float32(gr[1])) / np.float32(h)
    gx = torch.arange(w, device=dev, dtype=torch.float32) * float(sx) + gr[0]
    gy = torch.arange(h, device=dev, dtype=torch.float32) * float(sy) + gr[1]
    g = torch.stack([gx[None, None, :].expand(b, h, w),
                     gy[None, :, None].expand(b, h, w), labels], -1)
    labels = (g * rots[:, None, None, 2, :]).sum(-1) + dz[:, None, None]
    return points, labels


def device_augment(points: torch.Tensor, labels: torch.Tensor,
                   generator: torch.Generator, cfg: GndNetConfig) -> tuple:
    """Random per-sample rotation and height shift of (B, N, F) points
    with the exact transform of their (B, H, W) labels, drawn from
    `generator` on the points' device."""
    ang, dz = augment_draws(generator, points.shape[0], cfg)
    return apply_augment(points, labels, euler_zyx_matrices(ang), dz, cfg)
