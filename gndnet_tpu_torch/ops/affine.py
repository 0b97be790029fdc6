"""K3 (cell point counts) and K2 (capped per-cell PFN max and xyz sums).

Counterparts of `gndnet_tpu.ops.pallas_affine.histogram_counts_pallas` /
`histogram_ends` and of `affine_scan_t` in serving mode as read by the
forward of `_make_scan_gather`.  Each wrapper launches its hand-written
kernel (`csrc/cell_histogram.cu`, `csrc/affine_scan.cu`) for CUDA tensors
and runs its plain PyTorch version for CPU tensors; the plain versions
also run on the card as the kernels' oracle.
"""

from __future__ import annotations

import torch

from gndnet_tpu_torch import _ext

BIG_NEG = -3.0e38   # smax of an empty cell (pallas_affine._BIG_NEG)


# ---------------------------------------------------------------------------
# K3: per-cell counts
# ---------------------------------------------------------------------------

def _check_ids(local_cells: torch.Tensor) -> None:
    if local_cells.dtype != torch.int32 or local_cells.dim() != 2:
        raise ValueError("local_cells must be a (B, Np) int32 tensor")


def histogram_counts_plain(local_cells: torch.Tensor, ny: int,
                           nx: int) -> torch.Tensor:
    """(B, Np) int32 local cell ids -> (B, ny, nx) int32 counts; ids outside
    [0, ny*nx) (the drop id ny*nx, padding) are not counted."""
    _check_ids(local_cells)
    b, _ = local_cells.shape
    nc = ny * nx
    ok = (local_cells >= 0) & (local_cells < nc)
    item = torch.arange(b, device=local_cells.device)[:, None] * nc
    slot = torch.where(ok, local_cells.long() + item, b * nc).reshape(-1)
    counts = torch.zeros(b * nc + 1, dtype=torch.int32,
                         device=local_cells.device)
    counts.index_add_(0, slot, torch.ones_like(slot, dtype=torch.int32))
    return counts[:-1].view(b, ny, nx)


def histogram_counts(local_cells: torch.Tensor, ny: int,
                     nx: int) -> torch.Tensor:
    """Wrapper of K3: the counts of `histogram_counts_plain`, from the
    kernel for CUDA tensors.  Ids may be in any order."""
    _check_ids(local_cells)
    if local_cells.device.type == "cpu":
        return histogram_counts_plain(local_cells, ny, nx)
    _ext.require_cuda(local_cells, "local_cells")
    b, n = local_cells.shape
    if b == 0 or ny * nx == 0:
        raise ValueError("histogram needs at least one item and one cell")
    out = torch.empty((b, ny, nx), dtype=torch.int32,
                      device=local_cells.device)
    fn = _ext.function("cell_histogram_i32")
    _ext.check(fn(local_cells.data_ptr(), out.data_ptr(), b, n, ny * nx,
                  _ext.stream_ptr(out)), "cell_histogram_i32")
    histogram_counts.launches += 1
    return out


histogram_counts.launches = 0


def histogram_ends(local_cells: torch.Tensor, ny: int, nx: int, *,
                   counts_fn=histogram_counts):
    """Per-item run END row of every cell of a sorted id stream:
    ends = cumsum(counts) - 1 clipped at 0 (meaningless for empty cells).
    Returns (ends, counts), both (B, ny*nx) int32."""
    counts = counts_fn(local_cells, ny, nx).reshape(local_cells.shape[0], -1)
    ends = (torch.cumsum(counts, dim=-1) - 1).clamp_(min=0).to(torch.int32)
    return ends, counts


# ---------------------------------------------------------------------------
# K2: capped per-cell scan, gathered at each cell's last kept row
# ---------------------------------------------------------------------------

def _check_scan(pts, starts, counts, mmat, out_dtype):
    if pts.dtype != torch.float32 or pts.dim() != 2:
        raise ValueError("pts must be a (N, A) float32 tensor")
    if not 1 <= pts.shape[1] <= 8:
        raise ValueError(f"A={pts.shape[1]} feature rows; the kernel takes "
                         "1 to 8")
    if mmat.dtype != torch.float32 or mmat.shape[0] != pts.shape[1]:
        raise ValueError("mmat must be an (A, C) float32 tensor")
    if starts.dtype != torch.int32 or counts.dtype != torch.int32 \
            or starts.shape != counts.shape or starts.dim() != 1:
        raise ValueError("starts and counts must be (ncells,) int32")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported out_dtype {out_dtype}")


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 fused multiply-add: the f32 product is exact in f64, so only the
    final add rounds (twice, f64 then f32, which differs from one rounding
    only when the f64 sum falls exactly on an f32 rounding midpoint:
    about 2^-29 of the cases where the sum is inexact in f64)."""
    return (a.double() * b.double() + c.double()).float()


def affine_scan_gather_plain(pts, starts, counts, mmat, cap, out_dtype):
    """PyTorch version of K2 on any device, in the kernel's order: per
    point, a = round(fma chain of round(mmat) x round(pts)); per cell, the
    max of a and the f32 xyz sums over the first min(count, cap) rows from
    `starts`, accumulated row by row in stream order."""
    _check_scan(pts, starts, counts, mmat, out_dtype)
    n_rows, n_feat = pts.shape
    pr = pts.to(out_dtype).float()
    mr = mmat.to(out_dtype).float()
    acc = pr[:, :1] * mr[0]
    for k in range(1, n_feat):
        acc = _fma(mr[k], pr[:, k:k + 1], acc)
    act = acc.to(out_dtype).float()                       # (N, C)

    kept = counts if cap is None else counts.clamp(max=cap)
    best = torch.full((starts.shape[0], mmat.shape[1]), float("-inf"),
                      device=pts.device)
    sums = torch.zeros((starts.shape[0], 3), device=pts.device)
    last = max(n_rows - 1, 0)
    for r in range(int(kept.max()) if kept.numel() else 0):
        live = (r < kept)[:, None]
        rows = (starts.long() + r).clamp_(max=last)
        best = torch.where(live, torch.maximum(best, act[rows]), best)
        sums = torch.where(live, sums + pts[rows, :3], sums)
    best = torch.where(kept[:, None] > 0, best, BIG_NEG)
    tot = torch.cat([sums, kept.float()[:, None]], dim=1)
    return tot, best.to(out_dtype)


def affine_scan_gather(pts, starts, counts, mmat, cap, out_dtype):
    """Wrapper of K2.

    Args:
      pts: (N, A) float32 cell-sorted points (every row of a cell's run is
        a valid point), A <= 8.
      starts, counts: (ncells,) int32 run start and raw point count.
      mmat: (A, C) float32 per-point PFN matrix.
      cap: per-cell point cap, or None for no cap.
      out_dtype: torch.float32 or torch.bfloat16.
    Returns (tot (ncells, 4) float32 [sum x, sum y, sum z, kept count],
    smax (ncells, C) out_dtype).
    """
    _check_scan(pts, starts, counts, mmat, out_dtype)
    if pts.device.type == "cpu":
        return affine_scan_gather_plain(pts, starts, counts, mmat, cap,
                                        out_dtype)
    for name, t in (("pts", pts), ("starts", starts), ("counts", counts),
                    ("mmat", mmat)):
        _ext.require_cuda(t, name)
    ncells, width = starts.shape[0], mmat.shape[1]
    tot = torch.empty((ncells, 4), dtype=torch.float32, device=pts.device)
    smax = torch.empty((ncells, width), dtype=out_dtype, device=pts.device)
    fn = _ext.function("affine_scan_gather")
    _ext.check(fn(pts.data_ptr(), starts.data_ptr(), counts.data_ptr(),
                  mmat.data_ptr(), tot.data_ptr(), smax.data_ptr(), ncells,
                  pts.shape[1], width, -1 if cap is None else int(cap),
                  int(out_dtype == torch.bfloat16), _ext.stream_ptr(tot)),
               "affine_scan_gather")
    affine_scan_gather.launches += 1
    return tot, smax


affine_scan_gather.launches = 0
