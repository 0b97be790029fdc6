"""GroundEstimatorNet: raw scan -> elevation map, the fused path.

Counterpart of `gndnet_tpu.models.gndnet.GroundEstimatorNet` (setup and
`fused` with its three frontends; reference model.py:13-42).  The module
tree holds the reference's parameter names (`voxel_feature_extractor.*`,
`encoder_decoder.*`), so a reference state dict, or
`weights.state_dict_from_flax` of JAX variables, loads unchanged.

Output is (B, ny, nx) float32 elevation, B >= 1.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from gndnet_tpu_torch._ext import resolve_device
from gndnet_tpu_torch.config import GndNetConfig
from gndnet_tpu_torch.models.pfn import PillarFeatureNet
from gndnet_tpu_torch.models.segnet import SegnetGndEst, no_tf32
from gndnet_tpu_torch.ops import pillarize as pz


def compute_dtype(cfg: GndNetConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


class GroundEstimatorNet(nn.Module):
    """The model on `device` (the card unless device='cpu'), in eval mode:
    `fused(train=True)` selects batch statistics itself.  Its initial
    weights are PyTorch's default init drawn from seed 0 in a forked RNG
    (the global RNG is left as it was); serving and training load a state
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

    def canvas(self, points: torch.Tensor, train: bool = False,
               reference: bool = False) -> torch.Tensor:
        """(B, N, F) raw points -> (B, ny, nx, C) post-PFN canvas,
        differentiable in the PFN parameters when autograd records (except
        through 'sorted').  `train=True` runs a use_norm PFN on batch
        statistics, through the scatter frontend whatever the impl, as the
        JAX package routes it.  `reference=True` takes the plain version of
        every kernel stage."""
        cfg = self.cfg
        if len(cfg.vfe_filters) != 1:
            raise ValueError("fused path requires a single PFN layer")
        points = torch.as_tensor(points, dtype=torch.float32,
                                 device=self.device)
        ctx = pz.bin_points_batch(points, self.geom)
        flat = points.reshape(-1, points.shape[-1])
        layer = self.voxel_feature_extractor.pfn_layers[0]
        impl = "bn_train" if cfg.use_norm and train else cfg.fused_impl
        if impl == "affine":
            kernel, bias = layer.effective_affine()
            return pz.affine_canvas(
                flat, ctx, self.geom, cfg.max_points_voxel, kernel, bias,
                with_distance=cfg.with_distance,
                exact_point_cap=cfg.exact_point_cap,
                compute_dtype=compute_dtype(cfg), reference=reference)
        if impl == "sorted" and train:
            raise NotImplementedError(
                "fused_impl='sorted' has no gradient: K7 has no backward, "
                "and the JAX package cannot differentiate its Pallas kernel "
                "either; train with 'scatter' or 'affine'")
        cap = cfg.max_points_voxel
        frontend = dict(with_distance=cfg.with_distance,
                        exact_point_cap=cfg.exact_point_cap)
        full_f32 = (cfg.matmul_precision == "highest"
                    and self.device.type == "cuda")
        if impl == "sorted":
            decorated, kept, sorted_cell, cell_count = \
                pz.fused_frontend_sorted(flat, ctx, self.geom, cap,
                                         reference=reference, **frontend)
        else:
            decorated, kept, cell_count = pz.fused_frontend(
                flat, ctx, self.geom, cap, **frontend)
        with no_tf32(full_f32):
            if impl == "bn_train":
                # the reference's BatchNorm1d divisor: occupied cells per
                # scan, capped at max_voxels, times max_points
                occ = (cell_count > 0).reshape(ctx.batch, -1).sum(dim=1)
                rows = torch.clamp(occ, max=cfg.max_voxels).sum() * cap
                acts, pad_floor = layer.activate_flat_bn_train(decorated,
                                                               rows)
            else:
                acts = layer.activate_flat(decorated)
                # a non-full pillar's zero rows give activate(0) to its max
                pad_floor = layer.activate_flat(
                    torch.zeros((1, decorated.shape[-1]),
                                device=decorated.device))[0]
        if impl == "sorted":
            return pz.canvas_from_sorted_activations(
                acts, kept, sorted_cell, cell_count, ctx, self.geom, cap,
                pad_floor=pad_floor, reference=reference)
        return pz.canvas_from_activations(acts, ctx, kept, cell_count,
                                          self.geom, cap, pad_floor=pad_floor)

    def fused(self, points: torch.Tensor, train: bool = False,
              reference: bool = False) -> torch.Tensor:
        """(B, N, F) raw points -> (B, ny, nx) float32 elevation.

        train=False serves under `torch.no_grad()`; train=True records the
        graph for the PFN and SegNet parameters and runs batch norm on
        batch statistics, updating the running ones ('affine': K4/K5
        forward, K6 backward; 'scatter': scatter-max, whose backward splits
        ties; 'sorted' raises)."""
        with contextlib.nullcontext() if train else torch.no_grad():
            canvas = self.canvas(points, train=train, reference=reference)
            return self.encoder_decoder(canvas, train=train)[..., 0]
