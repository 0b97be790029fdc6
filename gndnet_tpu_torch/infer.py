"""Serving engine: scan -> (elevation map, per-point labels), one scan at a
time or a burst of scans in one batched call.

Counterpart of `gndnet_tpu.infer.GroundInferenceEngine` (`_pad` with the
1e9 sentinel and bucket padding, `_prepare`, the int16 transfer option,
`transfer_features`, `infer`, `infer_many`, `warmup`): shift the cloud by
the lidar height, run the fused model, label each point against the
elevation map, and return numpy arrays.  The engine runs on the card unless
the caller passes device='cpu'.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gndnet_tpu_torch.config import GndNetConfig
from gndnet_tpu_torch.models.gndnet import GroundEstimatorNet
from gndnet_tpu_torch.ops.postproc import segment_cloud

_PAD_SENTINEL = 1e9  # pads bin far out of range -> seg label -1, no pillar


class GroundInferenceEngine:
    """Scan -> (elevation map, per-point segmentation) engine.

    Args:
      cfg: model config, any fused_impl ('scatter', 'sorted', 'affine').
      state_dict: weights in the reference's names
        (`weights.state_dict_from_flax` or `weights.init_state_dict`).
      threshold: segmentation threshold (the reference uses 0.08 in
        predict_ground.py:168).
      shift_cloud: add cfg.lidar_height to z first; None uses
        cfg.shift_cloud.
      bucket: pad scans up to a multiple of this many points.
      transfer_dtype: 'float32', or 'int16' to ship scans as 4 mm
        fixed point (half the host-to-device bytes).
      transfer_features: ship only the leading k >= 3 point columns and
        zero-fill the rest on the device.
      device: the card unless 'cpu' is passed; raises if CUDA is missing.
    """

    QUANT_SCALE = 1.0 / 256.0   # 4 mm resolution, +-128 m range in int16

    def __init__(self, cfg: GndNetConfig, state_dict, threshold: float = 0.08,
                 shift_cloud: bool | None = None, bucket: int = 4096,
                 transfer_dtype: str = "float32",
                 transfer_features: int | None = None, device=None):
        if transfer_dtype not in ("float32", "int16"):
            raise ValueError(f"unsupported transfer_dtype {transfer_dtype!r}")
        k = cfg.input_features if transfer_features is None \
            else int(transfer_features)
        if not 3 <= k <= cfg.input_features:
            raise ValueError(
                f"transfer_features must be in [3, {cfg.input_features}], "
                f"got {transfer_features}")
        self.cfg = cfg
        self.threshold = float(threshold)
        self.shift = cfg.shift_cloud if shift_cloud is None else shift_cloud
        self.bucket = bucket
        self.transfer_dtype = transfer_dtype
        self.transfer_features = k
        self.model = GroundEstimatorNet(cfg, device=device)
        self.model.load_state_dict(state_dict)
        self.device = self.model.device
        self._shift = torch.tensor(
            [0.0, 0.0, cfg.lidar_height if self.shift else 0.0]
            + [0.0] * (cfg.input_features - 3), device=self.device)

    def _pad(self, points: np.ndarray) -> np.ndarray:
        n = points.shape[0]
        target = max(self.bucket, -(-n // self.bucket) * self.bucket)
        if n != target:
            pad = np.full((target - n, points.shape[1]), _PAD_SENTINEL,
                          points.dtype)
            points = np.concatenate([points, pad])
        if self.transfer_dtype == "int16":
            points = np.clip(np.rint(points / self.QUANT_SCALE),
                             -32768, 32767).astype(np.int16)
        return points

    def _prepare(self, points: np.ndarray) -> tuple:
        points = np.asarray(points, np.float32)
        k = self.transfer_features
        if points.shape[1] < k:
            points = np.concatenate(
                [points, np.zeros((points.shape[0], k - points.shape[1]),
                                  np.float32)], axis=1)
        return self._pad(points[:, :k]), points.shape[0]

    def device_points(self, padded: torch.Tensor) -> torch.Tensor:
        """Prepared (padded) scans, (Np, k) or stacked (K, Np, k) -> the
        (..., Np, input_features) float32 points the model sees, on the
        device: dequantised, zero-filled, shifted by the lidar height."""
        points = padded.to(self.device, non_blocking=True)
        if self.transfer_dtype == "int16":
            points = points.float() * self.QUANT_SCALE
        missing = self.cfg.input_features - self.transfer_features
        if missing:
            points = torch.nn.functional.pad(points, (0, missing))
        return points + self._shift

    @torch.no_grad()
    def run(self, padded: torch.Tensor, reference: bool = False):
        """Device-side program on a prepared (padded) scan tensor: returns
        (elevation (ny, nx) float32, labels (Np,) int8) on the device.
        `reference=True` takes the plain version of every kernel stage."""
        pts = self.device_points(padded)
        pred = self.model.fused(pts[None], reference=reference)[0]
        labels = segment_cloud(pts, self.cfg.grid_range,
                               self.cfg.voxel_size[0], pred.t(),
                               self.threshold)
        return pred, labels.to(torch.int8)

    @torch.no_grad()
    def run_many(self, padded: torch.Tensor, reference: bool = False):
        """Device-side program on K prepared scans of one bucket, stacked
        (K, Np, k): one fused call at B=K, then each scan labelled against
        its own map.  Returns (elevation (K, ny, nx) float32, labels
        (K, Np) int8) on the device.  `reference=True` takes the plain
        version of every kernel stage."""
        pts = self.device_points(padded)
        pred = self.model.fused(pts, reference=reference)
        labels = torch.stack([
            segment_cloud(p, self.cfg.grid_range, self.cfg.voxel_size[0],
                          e.t(), self.threshold) for p, e in zip(pts, pred)])
        return pred, labels.to(torch.int8)

    def infer_many(self, scans) -> list:
        """Batched inference of a burst of scans in one device call: all
        scans must fall into one padded bucket.  Returns [(elevation
        (ny, nx) np.float32, labels (N_i,) np.int8), ...] in submission
        order."""
        prepared = [self._prepare(s) for s in scans]
        shapes = {p.shape for p, _ in prepared}
        if len(shapes) != 1:
            raise ValueError(f"scans fall into mixed buckets {shapes}; "
                             "pad or split the burst")
        preds, labels = self.run_many(
            torch.from_numpy(np.stack([p for p, _ in prepared])))
        preds, labels = preds.cpu().numpy(), labels.cpu().numpy()
        return [(preds[i], labels[i][:n])
                for i, (_, n) in enumerate(prepared)]

    def infer(self, points: np.ndarray) -> tuple:
        """points: (N, >=3) float32 (extra columns beyond
        cfg.input_features are ignored, missing ones zero-filled).
        Returns (elevation (ny, nx) np.float32, labels (N,) np.int8 with
        values {1: obstacle, 0: ground, -1: out of grid})."""
        padded, n = self._prepare(points)
        pred, labels = self.run(torch.from_numpy(padded))
        return pred.cpu().numpy(), labels[:n].cpu().numpy()

    def warmup(self, n: int | None = None) -> float:
        """Serve one synthetic flat-plane scan (the reference's `dryrun`,
        ros_node.py:73-95), which builds and loads the kernels.  Returns
        the seconds it took."""
        n = n or self.cfg.num_points
        rng = np.random.default_rng(0)
        pts = np.zeros((n, self.cfg.input_features), np.float32)
        pts[:, 0] = rng.uniform(self.cfg.pc_range[0], self.cfg.pc_range[3], n)
        pts[:, 1] = rng.uniform(self.cfg.pc_range[1], self.cfg.pc_range[4], n)
        pts[:, 2] = -self.cfg.lidar_height
        t0 = time.perf_counter()
        self.infer(pts)
        return time.perf_counter() - t0
