"""SemanticKITTI ground-truth generation: raw scans -> training pairs.

Counterpart of `gndnet_tpu.data.generator` (reference
dataset_utils/gnd_data_generator/{dataset_generator_utils.py,
semKitti_morph_data_camera.py, semKitti_morph_data.py}): for each scan,
merge the .bin points with the .label classes, augment, take the ground
classes {40, 44, 48, 49, 60, 72}, rasterise a mean-z heightmap, fill holes
by linear interpolation with nearest-neighbour edge padding, drop cells
more than 0.1 m from their 5x5 neighbourhood mean and interpolate again
(<= 10 rounds), inject optional noise, crop the cloud to the grid box,
resample it to a fixed point count, and save `reduced_velo/%06d.npy` and
`gnd_labels/%06d.npy` (dataset_generator_utils.py:234-293,
semKitti_morph_data_camera.py:195-310).

The rasterisation and the per-point labels run on `device` (the card
unless 'cpu' is passed); the interpolation and outlier rounds stay scipy
on the host.
"""

from __future__ import annotations

import logging
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from gndnet_tpu_torch._ext import resolve_device
from gndnet_tpu_torch.config import GndNetConfig
from gndnet_tpu_torch.data.augmentation import AugmentationPipeline
from gndnet_tpu_torch.io_shim import crop_cloud
from gndnet_tpu_torch.ops.postproc import (lidar_to_heightmap,
                                           semantically_segment_cloud)

GROUND_CLASSES = (40, 44, 48, 49, 60, 72)


# ---------------------------------------------------------------------------
# SemanticKITTI parsing (reference dataset_generator_utils.py:83-135)
# ---------------------------------------------------------------------------

def _row_matrix(vals) -> np.ndarray:
    m = np.zeros((4, 4))
    m[0, :4] = vals[0:4]
    m[1, :4] = vals[4:8]
    m[2, :4] = vals[8:12]
    m[3, 3] = 1.0
    return m


def parse_calibration(path: str) -> dict:
    """calib.txt -> {key: 4x4 matrix}."""
    calib = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, content = line.strip().split(":", 1)
            calib[key] = _row_matrix([float(v) for v in content.split()])
    return calib


def parse_poses(path: str, calibration: dict) -> list:
    """poses.txt -> list of 4x4 velodyne-frame poses (Tr^-1 @ P @ Tr)."""
    tr = calibration["Tr"]
    tr_inv = np.linalg.inv(tr)
    with open(path) as f:
        return [tr_inv @ _row_matrix([float(v) for v in line.split()]) @ tr
                for line in f]


def load_scan(velodyne_path: str, label_path: str) -> np.ndarray:
    """(N, 4) [x, y, z, semantic_class] float32, the class the label
    file's word as stored (the reference merges the raw label column,
    semKitti_morph_data_camera.py:218-230)."""
    pts = np.fromfile(velodyne_path, np.float32).reshape(-1, 4)[:, :3]
    lab = np.fromfile(label_path, np.uint32).astype(np.float32)
    return np.concatenate([pts, lab[:, None]], axis=1).astype(np.float32)


def split_ground(cloud: np.ndarray, classes=GROUND_CLASSES):
    """(ground, obstacle) split on the label column
    (reference dataset_generator_utils.py:138-143)."""
    idx = np.isin(cloud[:, 3], classes)
    return cloud[idx], cloud[~idx]


# ---------------------------------------------------------------------------
# ground-plane computation
# ---------------------------------------------------------------------------

def compute_ground_plane(cloud: np.ndarray, grid_range, cell_size: float,
                         lidar_height: float, max_iterations: int = 10,
                         outlier_threshold: float = 0.1,
                         logger=logging.root, device=None):
    """(ground_points, elevation_grid[x, y] float64) from a labelled cloud
    (reference dataset_generator_utils.py:234-293).  The heightmap is
    rasterised on `device`; the hole filling and outlier rounds run on the
    host.  `generate_sequence` saves the grid's transpose (the saved
    labels are indexed [y, x])."""
    from scipy import signal
    from scipy.interpolate import LinearNDInterpolator, NearestNDInterpolator

    gnd, _ = split_ground(cloud)
    hm, counts = lidar_to_heightmap(
        torch.as_tensor(gnd[:, :3], dtype=torch.float32,
                        device=resolve_device(device)),
        tuple(grid_range), cell_size, max_points=100,
        lidar_height=lidar_height)
    hm = hm.cpu().numpy().astype(np.float64)
    filled = counts.cpu().numpy() > 0

    image_result = hm
    for it in range(max_iterations):
        ys, xs = np.where(filled)
        if len(ys) < 4:
            logger.warning("too few filled cells (%d); flat fallback", len(ys))
            image_result = np.zeros_like(hm)
            break
        interp = LinearNDInterpolator(list(zip(ys, xs)), hm[ys, xs])
        grid_y, grid_x = np.meshgrid(
            np.arange(hm.shape[0]), np.arange(hm.shape[1]), indexing="ij")
        linear = interp(grid_y, grid_x)

        empty = np.isnan(linear)
        if empty.any():
            ys2, xs2 = np.where(~empty)
            near = NearestNDInterpolator(list(zip(ys2, xs2)), linear[ys2, xs2])
            ye, xe = np.where(empty)
            linear[ye, xe] = np.nan_to_num(near(ye, xe))
        image_result = linear

        avg = signal.convolve2d(image_result, np.ones((5, 5)) / 25,
                                mode="same", boundary="symm")
        outliers = np.abs(image_result - avg) > outlier_threshold
        if not outliers.any():
            break
        filled = filled & ~outliers
        logger.debug("outlier pass %d: dropped %d cells", it, outliers.sum())

    return gnd, image_result


# ---------------------------------------------------------------------------
# the generation pipeline
# ---------------------------------------------------------------------------

@dataclass
class FrameResult:
    cloud: np.ndarray        # (num_points, 4) cropped+resampled [x y z seg]
    elevation: np.ndarray    # (H, W) float64, [y, x] indexed (transposed)


def process_frame(cloud: np.ndarray, cfg: GndNetConfig,
                  aug: AugmentationPipeline | None = None,
                  rng: np.random.Generator | None = None,
                  logger=logging.root, device=None) -> FrameResult | None:
    """One labelled scan -> (reduced cloud, elevation grid), or None if the
    scan yields no usable ground (reference compute_extract's error
    handling, semKitti_morph_data_camera.py:262-310)."""
    device = resolve_device(device)
    rng = rng or np.random.default_rng()
    cell = cfg.voxel_size[0]

    if aug is not None and aug.cfg.num_augmentations > 0:
        cloud = aug.augment_batch(cloud[None])[0]

    gnd, elevation_xy = compute_ground_plane(
        cloud, cfg.grid_range, cell, cfg.lidar_height, logger=logger,
        device=device)
    if gnd.shape[0] == 0:
        return None

    if aug is not None and aug.cfg.num_noise_var > 0:
        cloud = aug.add_noise(cloud, elevation_xy)

    seg = semantically_segment_cloud(
        torch.as_tensor(cloud[:, :3], dtype=torch.float32, device=device),
        cfg.grid_range, cell,
        torch.as_tensor(elevation_xy, dtype=torch.float32, device=device),
        cfg.lidar_height).cpu().numpy()

    labelled = np.concatenate([cloud[:, :3], seg[:, :1]], axis=1)
    cropped = crop_cloud(labelled, cfg.grid_range)
    if cropped.shape[0] < 2:
        return None
    idx = rng.integers(0, cropped.shape[0], cfg.num_points)
    reduced = cropped[idx].astype(np.float32)
    return FrameResult(cloud=reduced,
                       elevation=elevation_xy.T.astype(np.float64))


def generate_sequence(sequence_dir: str, out_dir: str, cfg: GndNetConfig,
                      frame_step: int = 1, start: int = 0,
                      count: int | None = None,
                      index_base: int | None = None,
                      seed: int | None = None,
                      logger=logging.root, device=None):
    """Process one SemanticKITTI sequence dir (velodyne/ + labels/) into
    out_dir/{reduced_velo,gnd_labels}/%06d.npy.

    Default mode (`index_base=None`): compact serial numbering, the k-th
    frame that yields ground is written as %06d of k; returns the number
    of frames written.

    Block mode (`index_base=j0`): the slice is one `frames_per_block` block
    of the stepped frame list (the reference's work split,
    semKitti_morph_data_camera.py:332-348).  The j-th frame of the slice
    is written as index_base + j (skips leave gaps) and the return value
    is the list of written positions; `generate_dataset` compacts the
    union of all blocks afterwards, so the files equal a serial run's.

    `seed` gives each frame a resampling rng from (seed, global position),
    so block and serial runs agree bit for bit (None keeps the reference's
    unseeded behaviour)."""
    device = resolve_device(device)
    velo_dir = os.path.join(sequence_dir, "velodyne")
    label_dir = os.path.join(sequence_dir, "labels")
    frames = sorted(f.split(".")[0] for f in os.listdir(label_dir))
    frames = frames[start::frame_step]
    if count is not None:
        frames = frames[:count]

    os.makedirs(os.path.join(out_dir, "reduced_velo"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "gnd_labels"), exist_ok=True)

    aug = AugmentationPipeline(cfg.augmentation, cfg.grid_range,
                               cfg.voxel_size)
    positions: list[int] = []
    for j, name in enumerate(frames):
        pos = (index_base or 0) + j
        rng = (np.random.default_rng((seed, pos))
               if seed is not None else None)
        cloud = load_scan(os.path.join(velo_dir, f"{name}.bin"),
                          os.path.join(label_dir, f"{name}.label"))
        if cfg.data_prep.camera_fov:
            cloud = aug.camera_fov(
                cloud, cfg.data_prep.fov_degrees,
                cfg.data_prep.fov_aspect_ratio, cfg.data_prep.fov_near,
                cfg.data_prep.fov_far)
        result = process_frame(cloud, cfg, aug, rng=rng, logger=logger,
                               device=device)
        if result is None:
            logger.warning("frame %s produced no ground; skipped", name)
            continue
        idx = pos if index_base is not None else len(positions)
        np.save(os.path.join(out_dir, "reduced_velo", f"{idx:06d}.npy"),
                result.cloud)
        np.save(os.path.join(out_dir, "gnd_labels", f"{idx:06d}.npy"),
                result.elevation)
        positions.append(pos)
    logger.info("%s [%d:+%d]: wrote %d frames", sequence_dir, start,
                len(frames), len(positions))
    return positions if index_base is not None else len(positions)


def compact_positional_outputs(out_dir: str, positions) -> int:
    """Rename position-named block outputs to the compact 0..n-1 numbering
    of a serial run (renames in ascending rank never collide, since
    rank <= position)."""
    for k, pos in enumerate(sorted(positions)):
        if k == pos:
            continue
        for sub in ("reduced_velo", "gnd_labels"):
            os.replace(os.path.join(out_dir, sub, f"{pos:06d}.npy"),
                       os.path.join(out_dir, sub, f"{k:06d}.npy"))
    return len(positions)


def generate_dataset(data_dir: str, out_dir: str, cfg: GndNetConfig,
                     sequences=None, seed: int | None = 0,
                     logger=logging.root, device=None) -> int:
    """Block-parallel generation: every sequence's stepped frame list is split
    into blocks of `frames_per_block` frames, scheduled over one
    ProcessPoolExecutor of `data_prep.num_workers` (reference
    semKitti_morph_data_camera.py:316-371), so one long sequence does not
    serialise on one worker.  Each sequence's numbering is then compacted
    to a serial run's.  Every worker runs on `device`."""
    device = resolve_device(device)
    seq_root = os.path.join(data_dir, "sequences")
    sequences = sequences or sorted(os.listdir(seq_root))
    fpb = max(1, cfg.data_prep.frames_per_block)
    step = max(1, cfg.data_prep.frame_step)

    jobs = []   # (seq_out_dir, generate_sequence args)
    for s in sequences:
        sdir = os.path.join(seq_root, s)
        odir = os.path.join(out_dir, "sequences", s)
        try:
            n_raw = len(os.listdir(os.path.join(sdir, "labels")))
        except OSError:
            logger.exception("cannot list %s; sequence skipped", sdir)
            continue
        n_stepped = -(-n_raw // step)
        for j0 in range(0, max(n_stepped, 1), fpb):
            # frames[j0*step::step][:fpb] == stepped[j0:j0+fpb]
            jobs.append((odir, (sdir, odir, cfg, step, j0 * step, fpb, j0,
                                seed)))

    total = 0
    workers = max(1, cfg.data_prep.num_workers)
    per_seq: dict[str, list] = {}
    if workers == 1 or len(jobs) == 1:
        for odir, args in jobs:
            per_seq.setdefault(odir, []).extend(
                generate_sequence(*args, logger=logger, device=device))
    else:
        # spawn, not the Linux fork default: a forked child cannot use
        # CUDA once the parent has initialised it
        with ProcessPoolExecutor(
                max_workers=workers,
                mp_context=multiprocessing.get_context("spawn")) as ex:
            futures = [(odir, ex.submit(generate_sequence, *args,
                                        device=str(device)))
                       for odir, args in jobs]
            failures = 0
            for odir, f in futures:
                try:
                    per_seq.setdefault(odir, []).extend(f.result())
                except Exception:
                    failures += 1
                    logger.exception("sequence block failed")
            if failures:
                logger.warning("%d sequence blocks failed", failures)
    for odir, positions in per_seq.items():
        total += compact_positional_outputs(odir, positions)
    return total
