"""Binning and the affine PFN canvas (the fused serving frontend).

Counterparts of `gndnet_tpu.ops.pillarize`: `PillarGeometry`,
`PointContext`, `_bin`, `bin_points`, `bin_points_batch`,
`affine_pfn_weights` and the B=1 packed-key branch of `affine_canvas`.

`affine_canvas` turns one raw scan into the post-PFN pseudo-image without
building the (pillars, points) tensor: sort one packed (cell, index) key per
point (K1), gather the rows in cell order, count each cell's points (K3),
take each cell's capped PFN max and xyz sums in stream order (K2), and add
the per-cell offset of the affine PFN split in a plain epilogue.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gndnet_tpu_torch.ops import affine, sort


class PillarGeometry(NamedTuple):
    """Static grid geometry."""

    pc_range: tuple          # (xmin, ymin, zmin, xmax, ymax, zmax)
    voxel_size: tuple        # (vx, vy, vz)
    grid_size: tuple         # (nx, ny, nz)

    @classmethod
    def from_config(cls, cfg) -> "PillarGeometry":
        return cls(tuple(cfg.pc_range), tuple(cfg.voxel_size),
                   tuple(cfg.grid_size))

    @property
    def nx(self):
        return self.grid_size[0]

    @property
    def ny(self):
        return self.grid_size[1]

    @property
    def nz(self):
        return self.grid_size[2]

    @property
    def num_cells_3d(self):
        return self.nx * self.ny * self.nz


class PointContext(NamedTuple):
    """Per-point binning over a flat point stream (possibly several scans).

    `cell` is a flat segment id: scan b's 3-D cell c maps to b * C3 + c, and
    every invalid point maps to the shared drop segment `num_segments - 1`.
    """

    cx: torch.Tensor         # (M,) int32 x-cell
    cy: torch.Tensor         # (M,) int32 y-cell
    cz: torch.Tensor         # (M,) int32 z-cell
    cell: torch.Tensor       # (M,) int32 flat segment id
    valid: torch.Tensor      # (M,) bool, inside the pc_range box
    num_segments: int        # batch * num_cells_3d + 1
    batch: int               # scan count folded into the flat stream


def _bin(points: torch.Tensor, geom: PillarGeometry):
    """Per-axis floor binning with range check (reference
    utils/point_cloud_ops.py:33-38): c = floor((p - lo) / v), invalid when
    c < 0 or c >= grid_size.  Float32 arithmetic, as in the JAX package."""
    out = []
    valid = None
    for k in range(3):
        c = torch.floor((points[..., k] - geom.pc_range[k])
                        / geom.voxel_size[k])
        ok = (c >= 0) & (c < geom.grid_size[k])
        valid = ok if valid is None else (valid & ok)
        out.append(c.to(torch.int32))
    return out[0], out[1], out[2], valid


def bin_points(points: torch.Tensor, geom: PillarGeometry) -> PointContext:
    """Bin one scan: points (N, F) -> PointContext with batch == 1."""
    cx, cy, cz, valid = _bin(points, geom)
    nx, ny, _ = geom.grid_size
    c3 = geom.num_cells_3d
    cell = torch.where(valid, (cz * ny + cy) * nx + cx, c3).to(torch.int32)
    return PointContext(cx, cy, cz, cell, valid, c3 + 1, 1)


def bin_points_batch(points_b: torch.Tensor,
                     geom: PillarGeometry) -> PointContext:
    """Bin a batch of scans (B, N, F) into one flat (B*N,) segment space."""
    b, n, _ = points_b.shape
    flat = points_b.reshape(b * n, -1)
    cx, cy, cz, valid = _bin(flat, geom)
    nx, ny, _ = geom.grid_size
    c3 = geom.num_cells_3d
    batch_ids = torch.arange(b, dtype=torch.int32,
                             device=flat.device).repeat_interleave(n)
    cell = batch_ids * c3 + (cz * ny + cy) * nx + cx
    cell = torch.where(valid, cell, b * c3).to(torch.int32)
    return PointContext(cx, cy, cz, cell, valid, b * c3 + 1, b)


def affine_pfn_weights(kernel: torch.Tensor, bias: torch.Tensor,
                       num_features: int, geom: PillarGeometry,
                       with_distance: bool = False):
    """Split the PFN linear over decorated features into a per-point matrix
    and a per-cell offset (the 'affine' decomposition).

    The decorated vector d_p = [p, xyz_p - mean_cell, xy_p - center_cell
    (, |xyz_p|)] is affine in p given its cell, so with kernel (in, out)
    rows split as [W_pts | W_clu | W_cen (| W_dst)]:
        z_p = p_aug @ M + w(cell),  M = W_pts + W_clu on xyz + W_cen on xy,
        w = bias - mean_cell @ W_clu - center_cell @ W_cen,
    and canvas[cell] = relu(segmax_p(p_aug @ M) + w[cell]).

    Returns (M, w_clu, w_cen, bias)."""
    f = num_features
    w_clu = kernel[f:f + 3]
    w_cen = kernel[f + 3:f + 5]
    m = kernel[:f].clone()
    m[0:3] += w_clu
    m[0:2] += w_cen
    if with_distance:
        m = torch.cat([m, kernel[f + 5:f + 6]], dim=0)
    return m, w_clu, w_cen, bias


def affine_canvas(points: torch.Tensor, ctx: PointContext,
                  geom: PillarGeometry, max_points: int,
                  kernel: torch.Tensor, bias: torch.Tensor, *,
                  with_distance: bool = False, exact_point_cap: bool = True,
                  compute_dtype: torch.dtype = torch.float32,
                  reference: bool = False) -> torch.Tensor:
    """One raw scan (N, F) float32 -> (1, ny, nx, C) canvas in
    compute_dtype.

    Reproduces `gndnet_tpu.ops.pillarize.affine_canvas` for B=1 with the
    packed key: the kept set is each cell's first `max_points` points in
    scan order (all of them without `exact_point_cap`), a cell's canvas
    row is relu(max over kept points of p_aug @ M + w(cell)), floored at
    relu(bias) when the cell holds fewer than `max_points` points (the
    reference's zero padding rows) and zero for an empty cell.

    `reference=True` runs the plain PyTorch version of every kernel stage
    on whatever device the points are on: the card-side oracle of K1-K3.
    """
    if geom.nz != 1:
        raise ValueError("affine canvas requires nz == 1")
    if ctx.batch != 1:
        raise NotImplementedError(
            "affine_canvas takes one scan: batched inference (B>1) is "
            "ROADMAP.md queue 1, 'Batched inference, B>1'")
    n = points.shape[0]
    c3 = geom.num_cells_3d
    idxcap = 1 << max(n - 1, 1).bit_length()
    if c3 * idxcap + (n - 1) >= 2**31:
        raise NotImplementedError(
            f"the packed (cell, index) key of {c3} cells x {n} points "
            "overflows 31 bits: grids such as fine_grid are ROADMAP.md "
            "queue 1, 'Batched inference, B>1' (the unpacked fallback)")
    if reference:
        sort_fn = sort.sort_i32_plain
        counts_fn = affine.histogram_counts_plain
        scan_fn = affine.affine_scan_gather_plain
    else:
        sort_fn = sort.sort_i32
        counts_fn = affine.histogram_counts
        scan_fn = affine.affine_scan_gather

    mmat, w_clu, w_cen, bias = affine_pfn_weights(
        kernel, bias, points.shape[1], geom, with_distance)

    # one unique key per point: cell-major, scan order within a cell, so
    # the sort is deterministic and each run lists its points in order
    local = torch.where(ctx.valid, ctx.cell, c3)
    key = local * idxcap + torch.arange(n, dtype=torch.int32,
                                        device=points.device)
    skey = sort_fn(key.to(torch.int32))
    local_s = torch.div(skey, idxcap, rounding_mode="floor")
    spts = points[(skey - local_s * idxcap).long()]

    ends, counts = affine.histogram_ends(local_s[None], geom.ny, geom.nx,
                                         counts_fn=counts_fn)
    counts = counts[0]
    starts = ends[0] - counts + 1

    if with_distance:
        spts = torch.cat([spts, torch.linalg.vector_norm(
            spts[:, :3], dim=1, keepdim=True)], dim=1)
    tot, smax = scan_fn(spts.contiguous(), starts.contiguous(), counts,
                        mmat.float().contiguous(),
                        max_points if exact_point_cap else None,
                        compute_dtype)
    count = torch.where(counts > 0, tot[:, 3], 0.0)
    mean = tot[:, :3] / torch.clamp(count, min=1.0)[:, None]

    # per-cell offset w = bias - mean @ W_clu - center @ W_cen, each product
    # of compute_dtype operands rounded to compute_dtype
    nx = geom.nx
    cell_ids = torch.arange(c3, device=points.device)
    vx, vy = geom.voxel_size[0], geom.voxel_size[1]
    centers = torch.stack(
        [(cell_ids % nx).float() * vx + (vx / 2.0 + geom.pc_range[0]),
         (cell_ids // nx).float() * vy + (vy / 2.0 + geom.pc_range[1])],
        dim=-1)

    def dot(x, w):
        return (x.to(compute_dtype).float()
                @ w.to(compute_dtype).float()).to(compute_dtype)

    w_cell = (bias.to(compute_dtype) - dot(mean, w_clu)
              - dot(centers, w_cen))
    canvas = torch.relu(smax + w_cell)
    pad_floor = torch.relu(bias.to(compute_dtype))
    occupied = count > 0
    has_padding_row = occupied & (count < max_points)
    canvas = torch.where(has_padding_row[:, None],
                         torch.maximum(canvas, pad_floor[None, :]), canvas)
    canvas = torch.where(occupied[:, None], canvas,
                         torch.zeros((), dtype=compute_dtype,
                                     device=canvas.device))
    return canvas.reshape(1, geom.ny, geom.nx, -1)
