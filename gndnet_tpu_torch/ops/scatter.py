"""Pillar features -> dense pseudo-image, the reference-style path's
scatter.

Counterpart of `gndnet_tpu.ops.scatter` (the reference's per-item scatter
loop, modules/pointpillars.py:168-199): one scatter over the batch, with
the padding pillars sent to a drop slot.
"""

from __future__ import annotations

import torch


def scatter_pillars_to_canvas(pillar_feats: torch.Tensor,
                              coors: torch.Tensor, mask: torch.Tensor,
                              ny: int, nx: int) -> torch.Tensor:
    """(B, M, C) pillar features at zyx `coors` (B, M, 3) -> (B, ny, nx, C)
    canvas; cells without a pillar are zero, pillars under ~mask are
    dropped.  Differentiable in `pillar_feats`.  Two pillars in one 2-D
    cell (nz > 1) leave the result to the order of the writes, as in the
    JAX package."""
    b, m, c = pillar_feats.shape
    cell = coors[..., 1].long() * nx + coors[..., 2].long()
    cell = torch.where(mask, cell, ny * nx)             # padding -> drop slot
    canvas = torch.zeros((b, ny * nx + 1, c), dtype=pillar_feats.dtype,
                         device=pillar_feats.device).scatter(
        1, cell[..., None].expand(b, m, c), pillar_feats)
    return canvas[:, :ny * nx].reshape(b, ny, nx, c)
