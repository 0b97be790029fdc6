"""Binning, the reference-style pillars and the three fused canvas
frontends.

Counterparts of `gndnet_tpu.ops.pillarize`: `PillarGeometry`,
`PointContext`, `_bin`, `bin_points`, `bin_points_batch`, `point_ranks`;
the reference-style path's `PillarBatch`, `PointRanks`, `count_and_rank`,
`pillarize`, `pillarize_batch` and `decorate_pillars` (materialised
(pillars, points) tensors, any nz), with `decorate_points` and
`scatter_max_canvas` over the flat stream;
`fused_frontend` and `canvas_from_activations` (the 'scatter' impl),
`fused_frontend_sorted` and `canvas_from_sorted_activations` (the 'sorted'
impl), `affine_pfn_weights` and `affine_canvas` (the 'affine' impl).

The scatter and sorted frontends decorate every point (its features, its
offset from its cell's kept-point mean and from the cell centre), mask the
points past each cell's cap, and leave the PFN to the caller; their canvas
is the per-cell max of the activations.  'scatter' sums and maxes with
duplicate-index scatters (`index_add_`, `scatter_reduce('amax')`, which on
the card add in atomic order; there `fused_frontend` sums in float64, so
its per-cell sums do not move with that order).  'sorted' sorts the stream by
cell once and reduces contiguous runs with K7.

`affine_canvas` turns raw scans into the post-PFN pseudo-image without
building the (pillars, points) tensor: sort one packed (cell, index) key per
point and item (K1 at B=1, a batched `torch.sort` at B>1, as the JAX
package leaves it to `lax.sort`; on grids whose key overflows 31 bits, K10
on the (cell, index) pairs at B=1 and a stable batched sort of the cell ids
at B>1), gather the rows in cell order, count each
cell's points (K3), take each cell's capped PFN max and xyz sums in stream
order (K2 when serving; K4/K5 with K6 as their backward when autograd
records a gradient), and add the per-cell offset of the affine PFN split in
a plain epilogue.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gndnet_tpu_torch.ops import affine, segment, sort


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


def exact_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d rounded as IEEE division rounds it, on every device.  PyTorch
    divides a CUDA tensor by a Python scalar as a product with the
    scalar's reciprocal, which moves a point on a cell's edge into the
    next cell (0.4 m cells); a 0-dim tensor on the tensor's device divides
    exactly, and a fill makes it without a host copy (graph capture)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _bin(points: torch.Tensor, geom: PillarGeometry):
    """Per-axis floor binning with range check (reference
    utils/point_cloud_ops.py:33-38): c = floor((p - lo) / v), invalid when
    c < 0 or c >= grid_size.  Float32 arithmetic, as in the JAX package."""
    out = []
    valid = None
    for k in range(3):
        c = torch.floor(exact_div(points[..., k] - geom.pc_range[k],
                                  geom.voxel_size[k]))
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


# ---------------------------------------------------------------------------
# the 'scatter' frontend
# ---------------------------------------------------------------------------

def segment_flags(sorted_cell: torch.Tensor) -> torch.Tensor:
    """(N,) bool: True where a run of a sorted id stream starts."""
    return torch.cat([torch.ones(1, dtype=torch.bool,
                                 device=sorted_cell.device),
                      sorted_cell[1:] != sorted_cell[:-1]])


def _run_start_positions(sorted_cell: torch.Tensor):
    """(positions, each row's run start), both (N,) int32."""
    pos = torch.arange(sorted_cell.shape[0], dtype=torch.int32,
                       device=sorted_cell.device)
    start = torch.where(segment_flags(sorted_cell), pos, 0)
    return pos, torch.cummax(start, dim=0).values


def stream_ranks(cell: torch.Tensor) -> torch.Tensor:
    """(M,) int32 occurrence rank of every entry of the id stream `cell`
    among the entries of its id, in stream order: a stable sort by id keeps
    each id's entries in order, so rank = sorted position - run start,
    scattered back."""
    order = torch.argsort(cell, stable=True)
    pos, start = _run_start_positions(cell[order])
    return torch.zeros_like(pos).scatter_(0, order, pos - start)


def point_ranks(ctx: PointContext) -> torch.Tensor:
    """(M,) int32 occurrence rank of every point within its cell, in stream
    order."""
    return stream_ranks(ctx.cell)


# ---------------------------------------------------------------------------
# the reference-style pillar path: materialised (pillars, points) tensors
# ---------------------------------------------------------------------------

class PillarBatch(NamedTuple):
    """Fixed-shape pillarization result (reference-style API)."""

    voxels: torch.Tensor      # (max_voxels, max_points, F) float
    coors: torch.Tensor       # (max_voxels, 3) int32, zyx order
    num_points: torch.Tensor  # (max_voxels,) int32, min(population, cap)
    mask: torch.Tensor        # (max_voxels,) bool, True for real pillars
    n_pillars: torch.Tensor   # () int32, number of real pillars


class PointRanks(NamedTuple):
    rank: torch.Tensor        # (M,) int32 occurrence index inside its cell
    kept: torch.Tensor        # (M,) bool valid & rank < max_points
    cell_count: torch.Tensor  # (num_segments,) int32 kept points per cell
    raw_count: torch.Tensor   # (num_segments,) int32 valid points per cell


def _segment_count(ctx: PointContext, flags: torch.Tensor) -> torch.Tensor:
    return torch.zeros(ctx.num_segments, dtype=torch.int32,
                       device=flags.device).index_add_(
        0, ctx.cell.long(), flags.to(torch.int32))


def count_and_rank(ctx: PointContext, max_points: int) -> PointRanks:
    """Rank, kept mask (the first `max_points` valid points of each cell
    in stream order) and per-segment kept and raw counts."""
    rank = point_ranks(ctx)
    kept = ctx.valid & (rank < max_points)
    return PointRanks(rank, kept, _segment_count(ctx, kept),
                      _segment_count(ctx, ctx.valid))


def pillarize_batch(points_b: torch.Tensor, geom: PillarGeometry,
                    max_points: int, max_voxels: int) -> PillarBatch:
    """Reference-style fixed-shape pillarization of B scans (B, N, F); every
    field has a leading batch axis.

    Scan b's pillars take slots 0.. in the order their cells are first
    touched in its point stream (the reference's voxel index,
    utils/point_cloud_ops.py:41-48; the out-of-range points take no slot).
    A pillar holds its cell's first `max_points` points in stream order;
    pillars past `max_voxels` are dropped whole, the earliest kept.
    `coors` are zyx, and `coors` and `num_points` are zero on padding
    slots.  Works on any nz.  The batch is binned once into one segment
    space; the first touches, ranks and slot orders are taken per scan."""
    b, n, f = points_b.shape
    dev = points_b.device
    ctx = bin_points_batch(points_b, geom)
    ranks = count_and_rank(ctx, max_points)
    c3 = geom.num_cells_3d
    item = torch.arange(b, dtype=torch.int32,
                        device=dev).repeat_interleave(n)
    local = torch.where(ctx.valid, ctx.cell - item * c3, c3).long()
    # each scan's cells [0, c3] (c3: its out-of-range segment) by first
    # touch; untouched cells and the out-of-range segment sort last, in id
    # order, as a stable argsort of the JAX package leaves them
    big = 2 * n + 1
    iota = torch.arange(n, dtype=torch.int32, device=dev).repeat(b)
    first = torch.full((b, c3 + 1), big, dtype=torch.int32,
                       device=dev).scatter_reduce(
        1, local.reshape(b, n), torch.where(ctx.valid, iota, big)
        .reshape(b, n), "amin", include_self=True)
    first[:, c3] = big
    by_creation = torch.argsort(first, dim=1, stable=True)   # slot -> cell
    creation = torch.empty_like(by_creation).scatter_(
        1, by_creation, torch.arange(c3 + 1, device=dev).expand(b, -1))
    slot = creation.reshape(-1)[
        local + item.long() * (c3 + 1)]                        # per point
    flat = (item.long() * max_voxels + slot) * max_points + ranks.rank
    drop = b * max_voxels * max_points
    flat = torch.where(ranks.kept & (slot < max_voxels), flat, drop)
    voxels = torch.zeros((drop + 1, f), dtype=points_b.dtype, device=dev)
    voxels[flat] = points_b.reshape(b * n, f)
    voxels = voxels[:drop].reshape(b, max_voxels, max_points, f)

    if max_voxels > c3 + 1:
        # more slots than cells: pad with the out-of-range segment
        by_creation = torch.cat([by_creation, torch.full(
            (b, max_voxels - c3 - 1), c3, dtype=by_creation.dtype,
            device=dev)], dim=1)
    slot_cells = by_creation[:, :max_voxels]
    counts = ranks.cell_count[:b * c3].reshape(b, c3)
    counts = torch.cat([counts, torch.zeros((b, 1), dtype=counts.dtype,
                                            device=dev)], dim=1)
    slot_counts = torch.gather(counts, 1, slot_cells)
    n_pillars = torch.clamp((counts[:, :c3] > 0).sum(dim=1),
                            max=max_voxels).to(torch.int32)
    mask = (torch.arange(max_voxels, device=dev)[None, :]
            < n_pillars[:, None])
    nx, ny = geom.nx, geom.ny
    coors = torch.stack([slot_cells // (nx * ny), (slot_cells // nx) % ny,
                         slot_cells % nx], dim=-1).to(torch.int32)
    coors = torch.where(mask[..., None], coors, 0)
    num_points = torch.where(mask, slot_counts, 0).to(torch.int32)
    return PillarBatch(voxels, coors, num_points, mask, n_pillars)


def pillarize(points: torch.Tensor, geom: PillarGeometry, max_points: int,
              max_voxels: int) -> PillarBatch:
    """`pillarize_batch` of one scan (N, F): the fields without the batch
    axis."""
    out = pillarize_batch(points[None], geom, max_points, max_voxels)
    return PillarBatch(*(x[0] for x in out))


def decorate_pillars(voxels: torch.Tensor, num_points: torch.Tensor,
                     coors_xy: torch.Tensor, geom: PillarGeometry,
                     max_points: int,
                     with_distance: bool = False) -> torch.Tensor:
    """PFN decoration of materialised pillars (..., P, F), on (M, P, F) or
    (B, M, P, F) (reference modules/pointpillars.py:115-140): [p, xyz - the
    mean of the pillar's `num_points` rows (sum / max(n, 1): padding rows
    are zero), xy - the cell centre from `coors_xy` (..., 2) (x, y) (,
    |xyz|)], then the padding rows zeroed.  Returns (..., P, F + 5 [+1])."""
    ftype = voxels.dtype
    denom = torch.clamp(num_points, min=1).to(ftype)[..., None, None]
    xyz = voxels[..., :3]
    mean = xyz.sum(dim=-2, keepdim=True) / denom
    vx, vy = geom.voxel_size[0], geom.voxel_size[1]
    cx = coors_xy[..., 0].to(ftype)[..., None] * vx + (
        vx / 2.0 + geom.pc_range[0])
    cy = coors_xy[..., 1].to(ftype)[..., None] * vy + (
        vy / 2.0 + geom.pc_range[1])
    feats = [voxels, xyz - mean,
             torch.stack([voxels[..., 0] - cx, voxels[..., 1] - cy], dim=-1)]
    if with_distance:
        feats.append(torch.linalg.vector_norm(xyz, dim=-1, keepdim=True))
    rows = torch.arange(max_points, device=voxels.device)
    pad = (rows < num_points[..., None]).to(ftype)[..., None]
    return torch.cat(feats, dim=-1) * pad


def _decorate(pts, cx, cy, mean_pp, keptf, geom, with_distance):
    """[p, xyz - cell mean, xy - cell centre (, |xyz|)] * kept, float32."""
    xyz = pts[:, :3]
    vx, vy = geom.voxel_size[0], geom.voxel_size[1]
    x_offset = vx / 2.0 + geom.pc_range[0]
    y_offset = vy / 2.0 + geom.pc_range[1]
    f_center = torch.stack(
        [pts[:, 0] - (cx.to(pts.dtype) * vx + x_offset),
         pts[:, 1] - (cy.to(pts.dtype) * vy + y_offset)], dim=-1)
    feats = [pts, xyz - mean_pp, f_center]
    if with_distance:
        feats.append(torch.linalg.vector_norm(xyz, dim=-1, keepdim=True))
    return torch.cat(feats, dim=-1) * keptf


def fused_frontend(points: torch.Tensor, ctx: PointContext,
                   geom: PillarGeometry, max_points: int,
                   with_distance: bool = False,
                   exact_point_cap: bool = True):
    """Flat (M, F) points -> (decorated (M, D), kept (M,) bool, cell_count
    (num_segments - 1,) int32): one rank sort when `exact_point_cap` (the
    first `max_points` points of each cell in stream order are kept; all
    in-range points without it), one scatter-add of [xyz * kept, kept] per
    cell and one gather back to the points.

    On the card the scatter-add adds in atomic order, and a float32 sum
    rounded in that order moved a use_norm train step's parameters by up
    to 1.6e-5 from one run to the next (its batch statistics amplify the
    cluster means' last bit).  There it runs in float64, which holds a
    cell's sum of float32 coordinates exactly unless their magnitudes span
    more than about 2^20, and rounds the sums to float32 once, before the
    mean.  On the CPU it adds in stream order in float32, as the JAX
    package's segment sum does."""
    if exact_point_cap:
        kept = ctx.valid & (point_ranks(ctx) < max_points)
    else:
        kept = ctx.valid
    keptf = kept.to(points.dtype)[:, None]
    cell = ctx.cell.long()
    acc = torch.float64 if points.is_cuda else points.dtype
    stats = torch.zeros((ctx.num_segments, 4), dtype=acc,
                        device=points.device).index_add_(
        0, cell, torch.cat([points[:, :3] * keptf, keptf], dim=-1)
        .to(acc)).to(points.dtype)
    per_point = stats[cell]
    mean_pp = per_point[:, :3] / torch.clamp(per_point[:, 3:4], min=1.0)
    decorated = _decorate(points, ctx.cx, ctx.cy, mean_pp, keptf, geom,
                          with_distance)
    cell_count = stats[:ctx.num_segments - 1, 3].to(torch.int32)
    return decorated, kept, cell_count


def decorate_points(points: torch.Tensor, ctx: PointContext,
                    ranks: PointRanks, geom: PillarGeometry,
                    with_distance: bool = False):
    """`decorate_pillars`' features over the flat (M, F) stream: cluster
    means from a masked segment sum over each cell's kept points, centre
    offsets from the point's own cell.  Returns (decorated (M, D), rows of
    dropped points zero; kept (M,) bool)."""
    keptf = ranks.kept.to(points.dtype)[:, None]
    cell = ctx.cell.long()
    sums = torch.zeros((ctx.num_segments, 3), dtype=points.dtype,
                       device=points.device).index_add_(
        0, cell, points[:, :3] * keptf)
    counts = torch.clamp(ranks.cell_count, min=1).to(points.dtype)
    mean_pp = sums[cell] / counts[cell][:, None]
    return (_decorate(points, ctx.cx, ctx.cy, mean_pp, keptf, geom,
                      with_distance), ranks.kept)


def _finish_canvas(rows, cell_count, max_points, pad_floor, batch, geom):
    """The reference's padding-row floor (a non-full pillar's zero rows give
    activate(0) to its max) and zero for empty cells."""
    occupied = cell_count > 0
    canvas = rows
    if pad_floor is not None:
        has_padding_row = occupied & (cell_count < max_points)
        canvas = torch.where(has_padding_row[:, None],
                             torch.maximum(canvas,
                                           pad_floor[None, :].to(rows.dtype)),
                             canvas)
    canvas = torch.where(occupied[:, None], canvas,
                         torch.zeros((), dtype=rows.dtype, device=rows.device))
    return canvas.reshape(batch, geom.ny, geom.nx, -1)


def masked_activations(acts: torch.Tensor,
                       kept: torch.Tensor) -> torch.Tensor:
    """The max's input: the activations of kept rows, the dtype's lowest
    value elsewhere."""
    # a Python scalar, not a device tensor made from host data: no copy, so
    # the serving graph can capture it
    return torch.where(kept[:, None], acts,
                       torch.finfo(acts.dtype).min).contiguous()


def canvas_from_activations(point_feats: torch.Tensor, ctx: PointContext,
                            kept: torch.Tensor, cell_count: torch.Tensor,
                            geom: PillarGeometry, max_points: int,
                            pad_floor: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Per-cell max of the kept points' (M, C) features into the (B, ny,
    nx, C) canvas by one scatter-max.  Differentiable in `point_feats` and
    `pad_floor`: a cell's cotangent splits equally among its tied maxima
    and 1/2 : 1/2 on a tie with the floor, as JAX's scatter-max and
    `jnp.maximum` split it."""
    if geom.nz != 1:
        raise ValueError("fused canvas scatter requires nz == 1")
    m, c = point_feats.shape
    index = ctx.cell.long()[:, None].expand(m, c)
    canvas = torch.full((ctx.num_segments, c),
                        torch.finfo(point_feats.dtype).min,
                        dtype=point_feats.dtype,
                        device=point_feats.device).scatter_reduce(
        0, index, masked_activations(point_feats, kept), "amax",
        include_self=True)
    return _finish_canvas(canvas[:ctx.num_segments - 1], cell_count,
                          max_points, pad_floor, ctx.batch, geom)


def scatter_max_canvas(point_feats: torch.Tensor, ctx: PointContext,
                       ranks: PointRanks, geom: PillarGeometry,
                       max_points: int,
                       pad_floor: torch.Tensor | None = None) -> torch.Tensor:
    """`canvas_from_activations` on `count_and_rank`'s kept mask and
    counts: the (B, ny, nx, C) per-cell max of the kept points' features,
    floored at `pad_floor` where a cell holds fewer than `max_points`
    points, zero where it holds none.  Requires nz == 1."""
    return canvas_from_activations(
        point_feats, ctx, ranks.kept,
        ranks.cell_count[:ctx.num_segments - 1], geom, max_points,
        pad_floor=pad_floor)


# ---------------------------------------------------------------------------
# the 'sorted' frontend (K7)
# ---------------------------------------------------------------------------

def _run_starts(sorted_cell: torch.Tensor, ncells: int) -> torch.Tensor:
    """Each cell id's first row in a sorted stream (clipped into range;
    meaningless for an absent id)."""
    starts = torch.searchsorted(
        sorted_cell, torch.arange(ncells, dtype=sorted_cell.dtype,
                                  device=sorted_cell.device), side="left")
    return starts.clamp(0, sorted_cell.shape[0] - 1)


class SortedStream(NamedTuple):
    """A flat point stream sorted by cell id (stable), padded with dropped
    rows to a multiple of the K7 chunk."""

    spts: torch.Tensor         # (N, F) points
    cx: torch.Tensor           # (N,) int32 x-cell, recomputed
    cy: torch.Tensor           # (N,) int32 y-cell, recomputed
    sorted_cell: torch.Tensor  # (N,) int32, non-decreasing
    kept: torch.Tensor         # (N,) bool valid & rank < max_points
    xyzk: torch.Tensor         # (N, 4) [xyz * kept, kept], K7's sum input


def sorted_stream(points: torch.Tensor, ctx: PointContext,
                  geom: PillarGeometry, max_points: int,
                  exact_point_cap: bool = True,
                  chunk: int = 1024) -> SortedStream:
    """One stable argsort by cell, rank = position - run start; cell
    coordinates and validity are recomputed from the sorted points."""
    m = points.shape[0]
    pad = (-m) % chunk
    order = torch.argsort(ctx.cell, stable=True)
    spts = points[order]
    cx, cy, _, valid = _bin(spts, geom)
    sorted_cell = ctx.cell[order]
    if pad:
        spts = torch.nn.functional.pad(spts, (0, 0, 0, pad))
        cx = torch.nn.functional.pad(cx, (0, pad))
        cy = torch.nn.functional.pad(cy, (0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
        sorted_cell = torch.nn.functional.pad(sorted_cell, (0, pad),
                                              value=ctx.num_segments - 1)
    pos, start = _run_start_positions(sorted_cell)
    kept = valid & ((pos - start) < max_points) if exact_point_cap else valid
    keptf = kept.to(points.dtype)[:, None]
    xyzk = torch.cat([spts[:, :3] * keptf, keptf], dim=-1)
    return SortedStream(spts, cx, cy, sorted_cell, kept, xyzk)


def fused_frontend_sorted(points: torch.Tensor, ctx: PointContext,
                          geom: PillarGeometry, max_points: int,
                          with_distance: bool = False,
                          exact_point_cap: bool = True, chunk: int = 1024,
                          reference: bool = False):
    """The 'scatter' frontend over `sorted_stream`: every row's run totals
    come from two K7 sums (suffix, and prefix as the flipped suffix of the
    negated ids): totals = prefix + suffix - row.

    Returns (decorated (N, D), kept (N,), sorted_cell (N,) int32,
    cell_count (num_segments - 1,) int32), N the padded length, in SORTED
    order; pair with `canvas_from_sorted_activations`.
    `reference=True` takes K7's plain version."""
    reduce = (segment.suffix_segment_reduce_plain if reference
              else segment.suffix_segment_reduce)
    spts, cx, cy, sorted_cell, kept, xyzk = sorted_stream(
        points, ctx, geom, max_points, exact_point_cap, chunk)
    keptf = kept.to(points.dtype)[:, None]
    suffix = reduce(xyzk, sorted_cell, "sum", chunk)
    prefix = reduce(torch.flip(xyzk, (0,)), torch.flip(-sorted_cell, (0,)),
                    "sum", chunk).flip(0)
    totals = prefix + suffix - xyzk
    mean_pp = totals[:, :3] / torch.clamp(totals[:, 3:4], min=1.0)
    decorated = _decorate(spts, cx, cy, mean_pp, keptf, geom, with_distance)
    ncells = ctx.num_segments - 1
    starts = _run_starts(sorted_cell, ncells)
    ids = torch.arange(ncells, dtype=sorted_cell.dtype,
                       device=sorted_cell.device)
    cell_count = torch.where(sorted_cell[starts] == ids, totals[starts, 3],
                             0.0).to(torch.int32)
    return decorated, kept, sorted_cell, cell_count


def canvas_from_sorted_activations(acts: torch.Tensor, kept: torch.Tensor,
                                   sorted_cell: torch.Tensor,
                                   cell_count: torch.Tensor,
                                   ctx: PointContext, geom: PillarGeometry,
                                   max_points: int,
                                   pad_floor: torch.Tensor | None = None,
                                   chunk: int = 1024,
                                   reference: bool = False) -> torch.Tensor:
    """Canvas from SORTED (N, C) activations: a K7 suffix max of the kept
    rows, then one gather of each cell's first row.  Not differentiable
    (the JAX package has no gradient through its Pallas kernel either).
    `reference=True` takes K7's plain version."""
    if geom.nz != 1:
        raise ValueError("fused canvas requires nz == 1")
    reduce = (segment.suffix_segment_reduce_plain if reference
              else segment.suffix_segment_reduce)
    reduced = reduce(masked_activations(acts, kept), sorted_cell, "max",
                     chunk)
    rows = reduced[_run_starts(sorted_cell, ctx.num_segments - 1)]
    return _finish_canvas(rows, cell_count, max_points, pad_floor, ctx.batch,
                          geom)


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


def pair_keys(num_cells_3d: int, n: int) -> bool:
    """Whether a scan of n points on a grid of num_cells_3d cells
    overflows `cell_stream`'s packed 31-bit (cell, index) key, its drop id
    included, so that the stream sorts (cell, index) pairs: K10 at B=1."""
    idxcap = 1 << max(n - 1, 1).bit_length()
    return num_cells_3d * idxcap + (n - 1) >= 2**31


def cell_stream(points: torch.Tensor, ctx: PointContext,
                geom: PillarGeometry, *, reference: bool = False):
    """The cell-sorted stream of B scans: (spts (B*N, F) rows sorted by
    (item, cell, scan index), starts and counts (B * num_cells_3d,) int32
    of every cell's run in it).  Dropped points sort after their item's
    cells.  Where (cell, index) packs into one 31-bit key, K1 sorts it at
    B=1 and a batched `torch.sort` at B>1; on grids where it does not
    (fine_grid), K10 sorts the (cell, index) pairs at B=1 and a stable
    batched `torch.sort` the cell ids at B>1, as the JAX package leaves the
    batched sorts to `lax.sort`.  K3 counts.  `reference=True` takes the
    plain versions."""
    b = ctx.batch
    m, f = points.shape
    n = m // b
    c3 = geom.num_cells_3d
    ends_fn = (affine.histogram_ends_plain if reference
               else affine.histogram_ends)
    # every item has its own cell space [0, c3] (c3: its drop id); within a
    # cell the rows keep scan order, so each run lists its points in order
    dev = points.device
    item = torch.arange(b, dtype=torch.int32, device=dev)
    local = torch.where(ctx.valid, ctx.cell - item.repeat_interleave(n) * c3,
                        c3).reshape(b, n)
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    if not pair_keys(c3, n):
        # one unique key per point and item, cell-major: the sort is
        # deterministic and needs no stability
        idxcap = 1 << max(n - 1, 1).bit_length()
        key = (local * idxcap + iota).to(torch.int32)
        if b == 1:
            sort_fn = sort.sort_i32_plain if reference else sort.sort_i32
            skey = sort_fn(key[0])[None]
        else:
            skey = torch.sort(key, dim=-1).values
        local_s = torch.div(skey, idxcap, rounding_mode="floor")
        order = (skey - local_s * idxcap).long()
    elif b == 1:
        sort_fn = sort.sort2_i32_plain if reference else sort.sort2_i32
        local_s, order = sort_fn(local[0], iota)
        local_s, order = local_s[None], order.long()[None]
    else:
        local_s, order = torch.sort(local, dim=-1, stable=True)
    spts = points.reshape(b, n, f)[item.long()[:, None], order].reshape(m, f)
    ends, counts = ends_fn(local_s, geom.ny, geom.nx)
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

    Reproduces `gndnet_tpu.ops.pillarize.affine_canvas` on every grid: the
    kept set is each cell's first `max_points` points in scan order
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
    return _finish_canvas(torch.relu(smax + w_cell), count, max_points,
                          torch.relu(bias.to(compute_dtype)), b, geom)
