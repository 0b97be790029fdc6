"""Binning and the affine PFN canvas (the fused serving frontend).

Counterparts of `gndnet_tpu.ops.pillarize`: `PillarGeometry`,
`PointContext`, `_bin`, `bin_points`, `bin_points_batch`,
`affine_pfn_weights` and the packed-key branches of `affine_canvas`.

`affine_canvas` turns raw scans into the post-PFN pseudo-image without
building the (pillars, points) tensor: sort one packed (cell, index) key per
point and item (K1 at B=1, a batched `torch.sort` at B>1, as the JAX
package leaves it to `lax.sort`), gather the rows in cell order, count each
cell's points (K3), take each cell's capped PFN max and xyz sums in stream
order (K2 when serving; K4/K5 with K6 as their backward when autograd
records a gradient), and add the per-cell offset of the affine PFN split in
a plain epilogue.
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


def cell_stream(points: torch.Tensor, ctx: PointContext,
                geom: PillarGeometry, *, reference: bool = False):
    """The cell-sorted stream of B scans: (spts (B*N, F) rows sorted by
    (item, cell, scan index), starts and counts (B * num_cells_3d,) int32
    of every cell's run in it).  Dropped points sort after their item's
    cells.  K1 sorts at B=1, a batched `torch.sort` at B>1; K3 counts.
    `reference=True` takes the plain versions."""
    b = ctx.batch
    m, f = points.shape
    n = m // b
    c3 = geom.num_cells_3d
    idxcap = 1 << max(n - 1, 1).bit_length()
    if c3 * idxcap + (n - 1) >= 2**31:
        raise NotImplementedError(
            f"the packed (cell, index) key of {c3} cells x {n} points "
            "overflows 31 bits: grids such as fine_grid are ROADMAP.md "
            "queue 1, 'The fine_grid fallback' (the unpacked sort)")
    sort_fn = sort.sort_i32_plain if reference else sort.sort_i32
    counts_fn = (affine.histogram_counts_plain if reference
                 else affine.histogram_counts)
    # one unique key per point and item: cell-major, scan order within a
    # cell, so the sort is deterministic and each run lists its points in
    # order; every item has its own cell space [0, c3] (c3: its drop id)
    dev = points.device
    item = torch.arange(b, dtype=torch.int32, device=dev)
    local = torch.where(ctx.valid, ctx.cell - item.repeat_interleave(n) * c3,
                        c3).reshape(b, n)
    key = (local * idxcap
           + torch.arange(n, dtype=torch.int32, device=dev)).to(torch.int32)
    if b == 1:
        skey = sort_fn(key[0])[None]
    else:
        skey = torch.sort(key, dim=-1).values
    local_s = torch.div(skey, idxcap, rounding_mode="floor")
    order = (skey - local_s * idxcap).long()
    spts = points.reshape(b, n, f)[item.long()[:, None], order].reshape(m, f)
    ends, counts = affine.histogram_ends(local_s, geom.ny, geom.nx,
                                         counts_fn=counts_fn)
    # global run starts in the flat (b * n) stream
    starts = (ends - counts + 1 + item[:, None] * n).reshape(-1)
    return spts, starts.contiguous(), counts.reshape(-1)


def affine_canvas(points: torch.Tensor, ctx: PointContext,
                  geom: PillarGeometry, max_points: int,
                  kernel: torch.Tensor, bias: torch.Tensor, *,
                  with_distance: bool = False, exact_point_cap: bool = True,
                  compute_dtype: torch.dtype = torch.float32,
                  reference: bool = False) -> torch.Tensor:
    """Raw flat points (B*N, F) float32 of B scans -> (B, ny, nx, C) canvas
    in compute_dtype.

    Reproduces `gndnet_tpu.ops.pillarize.affine_canvas` with the packed
    key: the kept set is each cell's first `max_points` points in scan order
    (all of them without `exact_point_cap`), a cell's canvas row is
    relu(max over kept points of p_aug @ M + w(cell)), floored at
    relu(bias) when the cell holds fewer than `max_points` points (the
    reference's zero padding rows) and zero for an empty cell.

    Differentiable in `kernel` and `bias` when autograd records (the
    `differentiable` path of the JAX function): the scan then runs
    `affine.ScanGather`, whose backward gives mmat its gradient, and the
    points get none.  `reference=True` runs the plain PyTorch version of
    every kernel stage on whatever device the points are on: the card-side
    oracle of the kernels.
    """
    if geom.nz != 1:
        raise ValueError("affine canvas requires nz == 1")
    b = ctx.batch
    c3 = geom.num_cells_3d
    mmat, w_clu, w_cen, bias = affine_pfn_weights(
        kernel, bias, points.shape[1], geom, with_distance)
    spts, starts, counts = cell_stream(points, ctx, geom,
                                       reference=reference)
    dev = points.device
    if with_distance:
        spts = torch.cat([spts, torch.linalg.vector_norm(
            spts[:, :3], dim=1, keepdim=True)], dim=1)
    tot, smax = affine.scan_gather(
        spts.contiguous(), starts, counts,
        mmat.float().contiguous(), max_points if exact_point_cap else None,
        compute_dtype, reference=reference)
    count = torch.where(counts > 0, tot[:, 3], 0.0)
    mean = tot[:, :3] / torch.clamp(count, min=1.0)[:, None]

    # per-cell offset w = bias - mean @ W_clu - center @ W_cen, each product
    # of compute_dtype operands rounded to compute_dtype
    nx = geom.nx
    cell_ids = torch.arange(b * c3, device=dev) % c3
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
    return canvas.reshape(b, geom.ny, geom.nx, -1)
