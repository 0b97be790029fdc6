"""Pillar Feature Net: parameters, the flat-stream activation and its
eval-mode affine map.

Counterpart of `gndnet_tpu.models.pfn`: the module tree carries the
reference's parameter names
(`voxel_feature_extractor.pfn_layers.<i>.linear.weight`, `...norm.*`).
`PFNLayer.activate_flat` is Linear (+ BatchNorm on running statistics) +
ReLU over a flat (N, D) decorated point stream, the PFN of the scatter and
sorted impls; `activate_flat_bn_train` is its use_norm training form, with
the batch statistics of the reference's padded pillar tensor derived from
the flat stream; `effective_affine` gives the eval-mode layer as one affine
map, which the affine canvas consumes.  `forward` is the per-pillar layer
of the reference-style path on (M, P, D) pillars, any depth of stack, with
use_norm's batch statistics over the valid pillars' rows.

The linear is `x @ kernel (+ bias)` in float32, as flax's Dense computes
it; batch norm follows flax's arithmetic and its running update (momentum
0.99, the BIASED variance).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from gndnet_tpu_torch.parallel.collectives import psum

FLAX_PFN_MOMENTUM = 0.99   # running = 0.99 * running + 0.01 * batch
BN_EPS = 1e-3


class PFNLayer(nn.Module):
    """Linear (+ BatchNorm1d(eps 1e-3, momentum 0.01) when use_norm, with a
    bias-free linear) + ReLU; non-last layers emit units = out // 2
    (reference modules/pointpillars.py:19-65)."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_norm: bool = False, last_layer: bool = False):
        super().__init__()
        self.use_norm = use_norm
        self.last_layer = last_layer
        units = out_channels if last_layer else out_channels // 2
        self.linear = nn.Linear(in_channels, units, bias=not use_norm)
        if use_norm:
            self.norm = nn.BatchNorm1d(units, eps=BN_EPS, momentum=0.01)

    def dense(self, x: torch.Tensor) -> torch.Tensor:
        """flax Dense: x @ kernel, then + bias (not fused into one addmm,
        whose CPU kernel adds in another order)."""
        z = x @ self.linear.weight.t()
        return z if self.linear.bias is None else z + self.linear.bias

    def activate_flat(self, x: torch.Tensor) -> torch.Tensor:
        """(..., D) -> relu(Linear (+ BN on running statistics)), as flax's
        `activate_flat(x, train=False)`: (z - mean) * (rsqrt(var + eps) *
        scale) + bias."""
        z = self.dense(x)
        if self.use_norm:
            n = self.norm
            z = ((z - n.running_mean)
                 * (torch.rsqrt(n.running_var + BN_EPS) * n.weight) + n.bias)
        return torch.relu(z)

    def bn_train_affine(self, s: torch.Tensor, q: torch.Tensor,
                        rows: torch.Tensor, bn_group=None):
        """Batch-statistics (inv, shift) from per-channel sums s and sums of
        squares q over `rows` pillar-tensor rows (a dynamic count, floored
        at 1): mean = s / rows, var = max(q / rows - mean^2, 0), with the
        gradient through both.  The running statistics move as flax's
        BatchNorm moves them on the 2-row surrogate [mean + sd, mean - sd],
        outside autograd.  With `bn_group` (the JAX package's `bn_axis`)
        s, q and rows are first summed over the group's ranks, so the
        statistics are the concatenated batch's even where the ranks hold
        different numbers of pillars."""
        rows = rows.float()
        if bn_group is not None:
            s, q = psum(s, bn_group), psum(q, bn_group)
            rows = psum(rows, bn_group)
        rows = torch.clamp(rows, min=1.0)
        mean = s / rows
        var = torch.maximum(q / rows - mean * mean, torch.zeros_like(q))
        n = self.norm
        with torch.no_grad():
            sdev = torch.sqrt(var)
            sur = torch.stack([mean + sdev, mean - sdev])
            m2 = sur.mean(dim=0)
            v2 = torch.clamp((sur * sur).mean(dim=0) - m2 * m2, min=0.0)
            keep = FLAX_PFN_MOMENTUM
            n.running_mean.copy_(keep * n.running_mean + (1.0 - keep) * m2)
            n.running_var.copy_(keep * n.running_var + (1.0 - keep) * v2)
            n.num_batches_tracked.add_(1)
        inv = n.weight / torch.sqrt(var + BN_EPS)
        return inv, n.bias - mean * inv

    def activate_flat_bn_train(self, decorated: torch.Tensor,
                               total_rows: torch.Tensor, bn_group=None):
        """use_norm training on the flat kept-masked (N, D) stream: the
        padded pillar tensor's pad rows (and dropped points) are zero rows,
        which the bias-free linear maps to z = 0, so one sum and one sum of
        squares over the flat z stream give its batch statistics with the
        reference's dynamic divisor `total_rows` (n_actual_pillars x
        max_points).  Returns (acts (N, C), pad_floor (C,) = relu(shift),
        what every padding row gives its pillar's max).  `bn_group`: as in
        `bn_train_affine`."""
        z = self.dense(decorated).float()
        inv, shift = self.bn_train_affine(z.sum(dim=0), (z * z).sum(dim=0),
                                          total_rows, bn_group)
        return torch.relu(z * inv + shift), torch.relu(shift)

    def forward(self, x: torch.Tensor, train: bool = False,
                pillar_mask: torch.Tensor | None = None) -> torch.Tensor:
        """(M, P, D) pillars -> (M, 1, units) if last, else (M, P, 2 *
        units): [activations, their max over the pillar's rows].

        use_norm in training normalises with batch statistics over the rows
        of the pillars `pillar_mask` (M,) flags (a pillar's padding rows
        included, as in the reference's dynamic tensor), divided by
        n_valid * P; without a mask, over every row.  The max is
        `torch.amax`, whose gradient splits evenly among tied rows as
        `jnp.max`'s does (padding rows tie at activate(0) in every non-full
        pillar)."""
        if self.use_norm and train:
            z = self.dense(x).float()
            if pillar_mask is None:
                zm = z
                rows = torch.tensor(float(z.shape[0] * z.shape[1]),
                                    device=z.device)
            else:
                zm = torch.where(pillar_mask[:, None, None], z, 0.0)
                rows = pillar_mask.float().sum() * z.shape[1]
            inv, shift = self.bn_train_affine(zm.sum(dim=(0, 1)),
                                              (zm * zm).sum(dim=(0, 1)),
                                              rows)
            x = torch.relu(z * inv + shift).to(x.dtype)
        else:
            x = self.activate_flat(x)
        x_max = torch.amax(x, dim=1, keepdim=True)
        if self.last_layer:
            return x_max
        return torch.cat([x, x_max.expand_as(x)], dim=2)

    def effective_affine(self):
        """Eval-mode (kernel (in, units), bias (units,)) of Linear (+ folded
        running-stat BN): y = scale * (W x - mean) / sqrt(var + eps) + bias.
        The kernel is in the JAX package's (in, out) layout."""
        kernel = self.linear.weight.t()
        if not self.use_norm:
            return kernel, self.linear.bias
        inv = self.norm.weight / torch.sqrt(self.norm.running_var + BN_EPS)
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

    def forward(self, decorated: torch.Tensor, train: bool = False,
                pillar_mask: torch.Tensor | None = None) -> torch.Tensor:
        """Decorated (M, P, D) pillars -> (M, C_out) pillar features."""
        x = decorated
        for layer in self.pfn_layers:
            x = layer(x, train=train, pillar_mask=pillar_mask)
        return x.squeeze(1)
