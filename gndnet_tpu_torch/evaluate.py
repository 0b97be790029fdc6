"""Evaluation harness: SemanticKITTI IoU / precision / recall / height MSE,
and height RMSE over a generated dataset.

Counterpart of `gndnet_tpu.evaluate` (reference evaluate_SemanticKITTI.py:
94-235), with the same metric definitions:

* predicted segmentation: the engine thresholds the cloud, shifted by the
  lidar height, against the predicted elevation (threshold 0 in the
  reference, :189);
* ground truth: classes {40, 44, 48, 49, 60, 72} are ground, raw labels
  {0, 1} are unlabeled and excluded (:94-100);
* both segmentations are filtered to the points valid in each (:102-111),
  inverted so ground == 1, then IoU / precision / recall on the ground bit;
* height MSE: masked squared error between pred.T and a heightmap of the
  ground points, the mask their occupancy (:120-128, :225-227).  With
  `reference_compat=True` the heightmap is the evaluation variant (count +
  1 divisor, unshifted z, utils/utils.py:271-295); otherwise both are
  corrected.

The engine and the rasterisations run on `device` (the card unless 'cpu'
is passed); the metrics are numpy on the host, as in the JAX package.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from gndnet_tpu_torch._ext import resolve_device
from gndnet_tpu_torch.config import GndNetConfig
from gndnet_tpu_torch.data.provider import GroundDataset
from gndnet_tpu_torch.infer import GroundInferenceEngine
from gndnet_tpu_torch.models.gndnet import GroundEstimatorNet
from gndnet_tpu_torch.ops.postproc import lidar_to_heightmap, lidar_to_img

GROUND_CLASSES = (40, 44, 48, 49, 60, 72)  # road/parking/sidewalk/other-ground/
                                           # lane-marking/terrain
UNLABELED = (0, 1)


def ground_truth_seg(sem_label: np.ndarray,
                     ground_classes=GROUND_CLASSES) -> np.ndarray:
    """{0: ground, 1: obstacle, -1: unlabeled} per point
    (reference get_GndSeg, evaluate_SemanticKITTI.py:94-100)."""
    seg = np.ones(sem_label.shape, np.float32)
    seg[np.isin(sem_label, ground_classes)] = 0.0
    seg[np.isin(sem_label, UNLABELED)] = -1.0
    return seg


def seg_metrics(pred_seg: np.ndarray, gt_seg: np.ndarray) -> tuple:
    """(iou, precision, recall) on the ground bit after joint outlier
    removal (reference evaluate_SemanticKITTI.py:102-111, 198-208)."""
    valid = (pred_seg >= 0) & (gt_seg >= 0)
    p = 1.0 - pred_seg[valid]
    g = 1.0 - gt_seg[valid]
    inter = np.sum(np.logical_and(g, p))
    union = np.sum(np.logical_or(g, p))
    iou = inter / union if union else 0.0
    prec = inter / p.sum() if p.sum() else 0.0
    rec = inter / g.sum() if g.sum() else 0.0
    return float(iou), float(prec), float(rec)


def height_mse(cfg: GndNetConfig, pred_elevation: np.ndarray,
               cloud: np.ndarray, sem_label: np.ndarray,
               reference_compat: bool = True, device=None) -> float:
    """Masked MSE between the prediction (ny, nx) and a heightmap of the
    ground-class points (reference get_target_gnd + :225-227); the two
    rasterisations run on `device`."""
    gnd = cloud[np.isin(sem_label, GROUND_CLASSES)][:, :3]
    if gnd.shape[0] == 0:
        return 0.0
    gnd = torch.as_tensor(gnd, dtype=torch.float32,
                          device=resolve_device(device))
    cell = cfg.voxel_size[0]
    shift = 0.0 if reference_compat else cfg.lidar_height
    mask = lidar_to_img(gnd, cfg.grid_range, cell, fill=1.0,
                        lidar_height=cfg.lidar_height).cpu().numpy()
    hm, _ = lidar_to_heightmap(gnd, cfg.grid_range, cell, max_points=100,
                               lidar_height=shift,
                               reference_eval_bug=reference_compat)
    hm = hm.cpu().numpy()
    denom = mask.sum()
    if denom == 0:
        return 0.0
    return float((np.square(hm - pred_elevation.T) * mask).sum() / denom)


@dataclass
class EvalResult:
    frames: int = 0
    iou: float = 0.0
    precision: float = 0.0
    recall: float = 0.0
    mse: float = 0.0
    per_frame: list = field(default_factory=list)

    def update(self, iou, prec, rec, mse):
        self.per_frame.append((iou, prec, rec, mse))
        self.frames += 1
        n = self.frames
        self.iou += (iou - self.iou) / n
        self.precision += (prec - self.precision) / n
        self.recall += (rec - self.recall) / n
        self.mse += (mse - self.mse) / n

    def as_dict(self):
        return {"frames": self.frames, "iou": self.iou,
                "precision": self.precision, "recall": self.recall,
                "mse": self.mse}


def evaluate_frames(cfg: GndNetConfig, state_dict, frames,
                    threshold: float = 0.0, reference_compat: bool = True,
                    logger=None, device=None) -> EvalResult:
    """Evaluate an iterable of (cloud (N, >=3) float32, sem_label (N,)
    uint32) with weights `state_dict` (the reference's names).

    The engine shifts the cloud by lidar_height as the reference's
    InferGround does (predict_ground.py:135) and segments at `threshold`
    (the reference's evaluation uses 0, evaluate_SemanticKITTI.py:189)."""
    engine = GroundInferenceEngine(cfg, state_dict, threshold=threshold,
                                   shift_cloud=True, device=device)
    result = EvalResult()
    for i, (cloud, sem_label) in enumerate(frames):
        pred, pred_seg = engine.infer(cloud)
        gt_seg = ground_truth_seg(sem_label)
        iou, prec, rec = seg_metrics(pred_seg, gt_seg)
        mse = height_mse(cfg, pred, cloud, sem_label, reference_compat,
                         engine.device)
        result.update(iou, prec, rec, mse)
        if logger:
            logger.info("frame %d: iou %.4f mse %.4f prec %.4f recall %.4f",
                        i, iou, mse, prec, rec)
    return result


def semantic_kitti_frames(data_dir: str):
    """Yield (cloud xyz (N, 3), label (N,) uint32) from a SemanticKITTI
    sequence dir with velodyne/*.bin + labels/*.label (reference
    evaluate_SemanticKITTI.py:152-185); the labels are read raw, as
    stored."""
    velo_dir = os.path.join(data_dir, "velodyne")
    label_dir = os.path.join(data_dir, "labels")
    for f in sorted(os.listdir(label_dir)):
        name = f.split(".")[0]
        cloud = np.fromfile(
            os.path.join(velo_dir, f"{name}.bin"), dtype=np.float32
        ).reshape(-1, 4)[:, :3]
        label = np.fromfile(
            os.path.join(label_dir, f"{name}.label"), dtype=np.uint32)
        yield cloud, label


def evaluate_semantic_kitti(cfg: GndNetConfig, state_dict, data_dir: str,
                            threshold: float = 0.0,
                            reference_compat: bool = True,
                            logger=None, device=None) -> EvalResult:
    """Directory-level harness of reference evaluate_SemanticKITTI.py."""
    return evaluate_frames(cfg, state_dict, semantic_kitti_frames(data_dir),
                           threshold, reference_compat, logger, device)


def evaluate_height_rmse(cfg: GndNetConfig, state_dict, data_dir: str,
                         split: str = "validation", skip_frames: int = 1,
                         logger=None, device=None) -> dict:
    """Height RMSE over a generated dataset (reduced_velo / gnd_labels
    pairs), against the elevation grids the model trains on.

    One fused forward per `cfg.batch_size` frames, with each frame's RMSE
    reduced on the device; the last, ragged batch is padded by repeating
    the last frame, and the padding is left out of the result.  Returns
    {'frames', 'rmse', 'per_frame'}."""
    device = resolve_device(device)
    ds = GroundDataset(data_dir, split, skip_frames, cfg.input_features,
                       max_memory=cfg.max_memory * 2 ** 20,
                       logger=logger or logging.root)
    model = GroundEstimatorNet(cfg, device=device)
    model.load_state_dict(state_dict)
    bs = max(1, int(cfg.batch_size))
    n = len(ds)
    per_frame = []
    for s in range(0, n, bs):
        idx = np.arange(s, min(s + bs, n))
        pad = bs - len(idx)
        full = np.concatenate([idx, np.full(pad, n - 1)]) if pad else idx
        clouds = torch.from_numpy(ds.data[full]).to(device)
        labels = torch.from_numpy(ds.labels[full]).to(device)
        pred = model.fused(clouds)
        rmses = torch.sqrt(((pred - labels) ** 2).mean(dim=(1, 2)))
        rmses = rmses.cpu().numpy()[:len(idx)]
        per_frame.extend(float(r) for r in rmses)
        if logger:
            for i, r in zip(idx, rmses):
                logger.info("frame %d: height RMSE %.4f", i, r)
    return {"frames": len(per_frame),
            "rmse": float(np.mean(per_frame)) if per_frame else 0.0,
            "per_frame": per_frame}
