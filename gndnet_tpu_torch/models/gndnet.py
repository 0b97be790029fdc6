"""GroundEstimatorNet: scan -> elevation map, by two paths.

Counterpart of `gndnet_tpu.models.gndnet.GroundEstimatorNet` (reference
model.py:13-42): `forward(voxels, coors, num_points, mask)` is the
reference-style path on materialised pillars (`ops.pillarize.
pillarize_batch`), decorate -> the PFN stack on (B*M, P, D) -> scatter ->
SegNet, which runs every configuration (a PFN of any depth, use_norm
training, nz > 1 grids); `fused(points)` is the fast path on raw points
with its three frontends (a single PFN layer).  The module tree holds the
reference's parameter names (`voxel_feature_extractor.*`,
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
from gndnet_tpu_torch.ops.scatter import scatter_pillars_to_canvas


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

    def _full_f32(self) -> bool:
        return (self.cfg.matmul_precision == "highest"
                and self.device.type == "cuda")

    def pillar_canvas(self, voxels: torch.Tensor, coors: torch.Tensor,
                      num_points: torch.Tensor, mask: torch.Tensor,
                      train: bool = False) -> torch.Tensor:
        """`pillarize_batch`'s fields -> (B, ny, nx, C) canvas: decorate,
        the PFN stack on (B*M, P, D) (in training with batch statistics
        over the valid pillars' rows), padding pillars zeroed, scatter."""
        cfg, dev = self.cfg, self.device
        voxels = torch.as_tensor(voxels, dtype=torch.float32, device=dev)
        coors = torch.as_tensor(coors, device=dev)
        num_points = torch.as_tensor(num_points, device=dev)
        mask = torch.as_tensor(mask, device=dev)
        decorated = pz.decorate_pillars(
            voxels, num_points, coors[..., [2, 1]], self.geom,
            cfg.max_points_voxel, with_distance=cfg.with_distance)
        b, m, p, d = decorated.shape
        with no_tf32(self._full_f32()):
            feats = self.voxel_feature_extractor(
                decorated.reshape(b * m, p, d), train=train,
                pillar_mask=mask.reshape(b * m)).reshape(b, m, -1)
        # the reference scatters its padding pillars too (zero rows at
        # cell 0 before any real pillar); they are masked here
        feats = torch.where(mask[..., None], feats, 0.0)
        return scatter_pillars_to_canvas(feats, coors, mask, self.geom.ny,
                                         self.geom.nx)

    def forward(self, voxels: torch.Tensor, coors: torch.Tensor,
                num_points: torch.Tensor, mask: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        """Reference-style forward on `pillarize_batch`'s fields: voxels
        (B, M, P, F), zyx coors (B, M, 3), num_points (B, M), mask (B, M)
        -> (B, ny, nx) float32 elevation.  train=False serves under
        `torch.no_grad()`; train=True records the graph and runs batch norm
        on batch statistics (the PFN's over the valid pillars' rows),
        updating the running ones."""
        with contextlib.nullcontext() if train else torch.no_grad():
            canvas = self.pillar_canvas(voxels, coors, num_points, mask,
                                        train=train)
            return self.encoder_decoder(canvas, train=train)[..., 0]

    def canvas(self, points: torch.Tensor, train: bool = False,
               reference: bool = False, bn_group=None) -> torch.Tensor:
        """(B, N, F) raw points -> (B, ny, nx, C) post-PFN canvas,
        differentiable in the PFN parameters when autograd records (except
        through 'sorted').  `train=True` runs a use_norm PFN on batch
        statistics, through the scatter frontend whatever the impl, as the
        JAX package routes it, its statistics over the ranks of `bn_group`
        (None: this process).  `reference=True` takes the plain version of
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
        if impl == "sorted":
            decorated, kept, sorted_cell, cell_count = \
                pz.fused_frontend_sorted(flat, ctx, self.geom, cap,
                                         reference=reference, **frontend)
        else:
            decorated, kept, cell_count = pz.fused_frontend(
                flat, ctx, self.geom, cap, **frontend)
        with no_tf32(self._full_f32()):
            if impl == "bn_train":
                # the reference's BatchNorm1d divisor: occupied cells per
                # scan, capped at max_voxels, times max_points
                occ = (cell_count > 0).reshape(ctx.batch, -1).sum(dim=1)
                rows = torch.clamp(occ, max=cfg.max_voxels).sum() * cap
                acts, pad_floor = layer.activate_flat_bn_train(
                    decorated, rows, bn_group)
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
              reference: bool = False, bn_group=None) -> torch.Tensor:
        """(B, N, F) raw points -> (B, ny, nx) float32 elevation.

        train=False serves under `torch.no_grad()`; train=True records the
        graph for the PFN and SegNet parameters and runs batch norm on
        batch statistics, updating the running ones ('affine': K4/K5
        forward, K6 backward; 'scatter': scatter-max, whose backward splits
        ties; 'sorted' raises).  With a process `bn_group` (the JAX
        package's `bn_axis`) every batch norm that trains on batch
        statistics (the SegNet's, a use_norm PFN's) takes them over all the
        group's ranks: sync-BN."""
        with contextlib.nullcontext() if train else torch.no_grad():
            canvas = self.canvas(points, train=train, reference=reference,
                                 bn_group=bn_group)
            return self.encoder_decoder(canvas, train=train,
                                        bn_group=bn_group)[..., 0]
