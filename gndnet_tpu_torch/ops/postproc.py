"""Per-point threshold segmentation against the elevation map.

Counterpart of `gndnet_tpu.ops.postproc._cell_indices` / `segment_cloud`
(reference utils/utils.py:198-220), keeping the reference's `0 < idx`
lower bound, which excludes grid row and column 0.  The per-point lookup is
a plain index gather.
"""

from __future__ import annotations

import torch


def _cell_indices(points: torch.Tensor, grid_range, cell_size: float):
    """floor((xy - grid_min) / cell) as int32 (reference utils.py:204-207)."""
    ix = torch.floor((points[:, 0] - grid_range[0]) / cell_size)
    iy = torch.floor((points[:, 1] - grid_range[1]) / cell_size)
    return ix.to(torch.int32), iy.to(torch.int32)


def segment_cloud(points: torch.Tensor, grid_range, cell_size: float,
                  elevation_map: torch.Tensor,
                  threshold: float = 0.2) -> torch.Tensor:
    """Per-point {1: obstacle, 0: ground, -1: out of grid} float32 labels.

    `elevation_map` is indexed [x_cell, y_cell], i.e. the transposed model
    output (reference predict_ground.py:168 passes pred_gnd.T)."""
    ix, iy = _cell_indices(points, grid_range, cell_size)
    h, w = elevation_map.shape
    inside = (ix > 0) & (ix < h) & (iy > 0) & (iy < w)
    flat = ix.clamp(0, h - 1).long() * w + iy.clamp(0, w - 1).long()
    elev = elevation_map.reshape(-1)[flat]
    obstacle = points[:, 2] > elev + threshold
    return torch.where(inside, obstacle.float(), -1.0)
