"""Pillar Feature Net parameters and their eval-mode affine map.

Counterpart of `gndnet_tpu.models.pfn` for the serving slice: the module
tree carries the reference's parameter names
(`voxel_feature_extractor.pfn_layers.<i>.linear.weight`, `...norm.*`), and
`PFNLayer.effective_affine` gives the layer as one affine map, which the
affine canvas consumes.  The per-pillar forward of the reference-style path
is not part of this slice.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class PFNLayer(nn.Module):
    """Linear (+ BatchNorm1d(eps 1e-3, momentum 0.01) when use_norm, with a
    bias-free linear) + ReLU; non-last layers emit units = out // 2
    (reference modules/pointpillars.py:19-65)."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_norm: bool = False, last_layer: bool = False):
        super().__init__()
        self.use_norm = use_norm
        units = out_channels if last_layer else out_channels // 2
        self.linear = nn.Linear(in_channels, units, bias=not use_norm)
        if use_norm:
            self.norm = nn.BatchNorm1d(units, eps=1e-3, momentum=0.01)

    def effective_affine(self):
        """Eval-mode (kernel (in, units), bias (units,)) of Linear (+ folded
        running-stat BN): y = scale * (W x - mean) / sqrt(var + eps) + bias.
        The kernel is in the JAX package's (in, out) layout."""
        kernel = self.linear.weight.t()
        if not self.use_norm:
            return kernel, self.linear.bias
        inv = self.norm.weight / torch.sqrt(self.norm.running_var + 1e-3)
        return (kernel * inv[None, :],
                self.norm.bias - self.norm.running_mean * inv)


class PillarFeatureNet(nn.Module):
    """Stack of PFNLayers as `pfn_layers` (reference
    modules/pointpillars.py:67-146)."""

    def __init__(self, num_input_features: int,
                 num_filters: Sequence[int] = (64,), use_norm: bool = False):
        super().__init__()
        widths = [num_input_features] + list(num_filters)
        self.pfn_layers = nn.ModuleList(
            PFNLayer(widths[i], widths[i + 1], use_norm,
                     last_layer=(i == len(num_filters) - 1))
            for i in range(len(num_filters)))
