"""GroundEstimatorNet: raw scan -> elevation map, the fused affine path.

Counterpart of `gndnet_tpu.models.gndnet.GroundEstimatorNet` (setup and the
affine branch of `fused`; reference model.py:13-42).  The module tree holds
the reference's parameter names (`voxel_feature_extractor.*`,
`encoder_decoder.*`), so a reference state dict, or
`weights.state_dict_from_flax` of JAX variables, loads unchanged.

Output is (B, ny, nx) float32 elevation with B = 1.
"""

from __future__ import annotations

import torch
from torch import nn

from gndnet_tpu_torch._ext import resolve_device
from gndnet_tpu_torch.config import GndNetConfig
from gndnet_tpu_torch.models.pfn import PillarFeatureNet
from gndnet_tpu_torch.models.segnet import SegnetGndEst
from gndnet_tpu_torch.ops import pillarize as pz


def compute_dtype(cfg: GndNetConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


class GroundEstimatorNet(nn.Module):
    """Eval-mode model on `device` (the card unless device='cpu').  Its
    initial weights are PyTorch's default init drawn from seed 0 in a
    forked RNG (the global RNG is left as it was); serving loads a state
    dict over them."""

    def __init__(self, cfg: GndNetConfig, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.cfg = cfg
        self.geom = pz.PillarGeometry.from_config(cfg)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            self.voxel_feature_extractor = PillarFeatureNet(
                cfg.num_decorated_features, cfg.vfe_filters, cfg.use_norm)
            self.encoder_decoder = SegnetGndEst(
                in_channels=cfg.vfe_filters[-1], dtype=compute_dtype(cfg),
                precision=cfg.matmul_precision)
        self.to(self.device)
        self.eval()

    def canvas(self, points: torch.Tensor,
               reference: bool = False) -> torch.Tensor:
        """(1, N, F) raw points -> (1, ny, nx, C) post-PFN canvas.
        `reference=True` takes the plain version of every kernel stage."""
        cfg = self.cfg
        if len(cfg.vfe_filters) != 1:
            raise ValueError("fused path requires a single PFN layer")
        if cfg.fused_impl != "affine":
            raise NotImplementedError(
                f"fused_impl={cfg.fused_impl!r}: only 'affine' is ported; the "
                "others are ROADMAP.md queue 1, 'The other forward paths'")
        points = torch.as_tensor(points, dtype=torch.float32,
                                 device=self.device)
        if points.shape[0] != 1:
            raise NotImplementedError(
                "fused() serves one scan: batched inference (B>1) is "
                "ROADMAP.md queue 1, 'Batched inference, B>1'")
        ctx = pz.bin_points_batch(points, self.geom)
        kernel, bias = (self.voxel_feature_extractor.pfn_layers[0]
                        .effective_affine())
        return pz.affine_canvas(
            points[0], ctx, self.geom, cfg.max_points_voxel, kernel, bias,
            with_distance=cfg.with_distance,
            exact_point_cap=cfg.exact_point_cap,
            compute_dtype=compute_dtype(cfg), reference=reference)

    @torch.no_grad()
    def fused(self, points: torch.Tensor, train: bool = False,
              reference: bool = False) -> torch.Tensor:
        """(1, N, F) raw points -> (1, ny, nx) float32 elevation."""
        if train:
            raise NotImplementedError(
                "training is ROADMAP.md queue 1, 'Training' (with kernels "
                "K4-K6 of queue 2)")
        canvas = self.canvas(points, reference=reference)
        return self.encoder_decoder(canvas)[..., 0]
