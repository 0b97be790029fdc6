"""K3 (cell point counts), K2 (capped per-cell PFN max and xyz sums), and
the training pair K4/K5 (K2 with the argmax row) and K6 (d(mmat)).

Counterparts of `gndnet_tpu.ops.pallas_affine.histogram_counts_pallas` /
`histogram_ends`, of `affine_scan_t` in serving mode and in its two argmax
modes as read by `_make_scan_gather`, of `affine_bwd_dmmat`, and of
`_make_scan_gather`'s custom VJP itself (`ScanGather`).  Each wrapper
launches its hand-written kernel (`csrc/cell_histogram.cu`,
`csrc/affine_scan.cu`, `csrc/affine_bwd.cu`) for CUDA tensors and runs its
plain PyTorch version for CPU tensors; the plain versions also run on the
card as the kernels' oracle.
"""

from __future__ import annotations

import torch

from gndnet_tpu_torch import _ext

BIG_NEG = -3.0e38   # smax of an empty cell (pallas_affine._BIG_NEG)
PACKED_MAX_CAP = 4096   # K5's 12-bit rank field


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


def _activations(pts, mmat, out_dtype):
    """(N, C) a = round(fma chain of round(mmat) x round(pts)) as f32, the
    chain starting from +0.0 as XLA's dot does (so never -0.0)."""
    pr = pts.to(out_dtype).float()
    mr = mmat.to(out_dtype).float()
    acc = torch.zeros((pts.shape[0], mmat.shape[1]), device=pts.device)
    for k in range(pts.shape[1]):
        acc = _fma(mr[k], pr[:, k:k + 1], acc)
    return acc.to(out_dtype).float()


def _walk_cells(pts, starts, counts, cap, step):
    """Visit rank r = 0, 1, ... of every cell's kept rows in stream order:
    step(r, live (ncells, 1), rows (ncells,)) per rank.  Returns the kept
    counts and tot (ncells, 4) = [f32 xyz sums in stream order, kept]."""
    kept = counts if cap is None else counts.clamp(max=cap)
    sums = torch.zeros((starts.shape[0], 3), device=pts.device)
    last = max(pts.shape[0] - 1, 0)
    for r in range(int(kept.max()) if kept.numel() else 0):
        live = (r < kept)[:, None]
        rows = (starts.long() + r).clamp_(max=last)
        step(r, live, rows)
        sums = torch.where(live, sums + pts[rows, :3], sums)
    return kept, torch.cat([sums, kept.float()[:, None]], dim=1)


def affine_scan_gather_plain(pts, starts, counts, mmat, cap, out_dtype):
    """PyTorch version of K2 on any device, in the kernel's order: per
    point, a = round(fma chain of round(mmat) x round(pts)); per cell, the
    max of a and the f32 xyz sums over the first min(count, cap) rows from
    `starts`, accumulated row by row in stream order."""
    _check_scan(pts, starts, counts, mmat, out_dtype)
    act = _activations(pts, mmat, out_dtype)
    best = torch.full((starts.shape[0], mmat.shape[1]), float("-inf"),
                      device=pts.device)

    def step(r, live, rows):
        nonlocal best
        best = torch.where(live, torch.maximum(best, act[rows]), best)

    kept, tot = _walk_cells(pts, starts, counts, cap, step)
    best = torch.where(kept[:, None] > 0, best, BIG_NEG)
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


# ---------------------------------------------------------------------------
# K4 / K5: K2 plus each cell's first argmax row (the training forward)
# ---------------------------------------------------------------------------

def packed_argmax(out_dtype, cap) -> bool:
    """`_make_scan_gather`'s choice: K5 (packed key) for bf16 values with a
    cap of at most 4096, K4 (value, row) otherwise."""
    return (out_dtype == torch.bfloat16 and cap is not None
            and cap <= PACKED_MAX_CAP)


def _mono16(v: torch.Tensor) -> torch.Tensor:
    """The total order of bf16 bit patterns, int32 in [0, 65535]."""
    bits = v.to(torch.bfloat16).view(torch.int16).int() & 0xFFFF
    return torch.where(bits >= 32768, 65535 - bits, bits + 32768)


def _unmono16(mono: torch.Tensor) -> torch.Tensor:
    bits = torch.where(mono >= 32768, mono - 32768, 65535 - mono)
    bits = torch.where(bits >= 32768, bits - 65536, bits)
    return bits.to(torch.int16).view(torch.bfloat16).float()


def affine_scan_argmax_plain(pts, starts, counts, mmat, cap, out_dtype,
                             packed):
    """PyTorch version of K4 (packed=False) and K5 (packed=True): K2's tot
    and smax, and argpos (ncells, C) int32, the global row of each cell's
    first kept row attaining the max (-1 for an empty cell).

    K4 takes a row only when its value is strictly greater, so ties keep
    the earlier row and -0.0 ties +0.0.  K5 maximises mono16(value) << 12 |
    (4095 - rank): -0.0 < +0.0, and equal values keep the lower rank."""
    _check_scan(pts, starts, counts, mmat, out_dtype)
    if packed and not packed_argmax(out_dtype, cap):
        raise ValueError("the packed argmax (K5) needs bf16 values and a cap "
                         f"of at most {PACKED_MAX_CAP}")
    act = _activations(pts, mmat, out_dtype)
    shape = (starts.shape[0], mmat.shape[1])
    best = torch.full(shape, float("-inf"), device=pts.device)
    pos = torch.full(shape, -1, dtype=torch.long, device=pts.device)
    key = torch.full(shape, -1, dtype=torch.int32, device=pts.device)

    def step(r, live, rows):
        nonlocal best, pos, key
        v = act[rows]
        if packed:
            key = torch.where(live, torch.maximum(
                key, (_mono16(v) << 12) | (PACKED_MAX_CAP - 1 - r)), key)
        else:
            take = live & ((v > best) | (r == 0))
            best = torch.where(take, v, best)
            pos = torch.where(take, rows[:, None], pos)

    kept, tot = _walk_cells(pts, starts, counts, cap, step)
    if packed:
        best = _unmono16(key >> 12)
        pos = starts.long()[:, None] + (PACKED_MAX_CAP - 1
                                        - (key & (PACKED_MAX_CAP - 1)))
    occupied = kept[:, None] > 0
    best = torch.where(occupied, best, BIG_NEG)
    pos = torch.where(occupied, pos, -1)
    return tot, best.to(out_dtype), pos.to(torch.int32)


def _scan_argmax(pts, starts, counts, mmat, cap, out_dtype, packed):
    """Launch K4 or K5 on the card."""
    for name, t in (("pts", pts), ("starts", starts), ("counts", counts),
                    ("mmat", mmat)):
        _ext.require_cuda(t, name)
    ncells, width = starts.shape[0], mmat.shape[1]
    tot = torch.empty((ncells, 4), dtype=torch.float32, device=pts.device)
    smax = torch.empty((ncells, width), dtype=out_dtype, device=pts.device)
    argpos = torch.empty((ncells, width), dtype=torch.int32,
                         device=pts.device)
    fn = _ext.function("affine_scan_argmax")
    _ext.check(fn(pts.data_ptr(), starts.data_ptr(), counts.data_ptr(),
                  mmat.data_ptr(), tot.data_ptr(), smax.data_ptr(),
                  argpos.data_ptr(), ncells, pts.shape[1], width,
                  -1 if cap is None else int(cap),
                  int(out_dtype == torch.bfloat16), int(packed),
                  _ext.stream_ptr(tot)), "affine_scan_argmax")
    return tot, smax, argpos


def affine_scan_argmax_pair(pts, starts, counts, mmat, cap, out_dtype):
    """Wrapper of K4 (f32 values, or no cap): (tot, smax, argpos) of
    `affine_scan_argmax_plain(..., packed=False)`."""
    _check_scan(pts, starts, counts, mmat, out_dtype)
    if pts.device.type == "cpu":
        return affine_scan_argmax_plain(pts, starts, counts, mmat, cap,
                                        out_dtype, packed=False)
    out = _scan_argmax(pts, starts, counts, mmat, cap, out_dtype, False)
    affine_scan_argmax_pair.launches += 1
    return out


affine_scan_argmax_pair.launches = 0


def affine_scan_argmax_packed(pts, starts, counts, mmat, cap, out_dtype):
    """Wrapper of K5 (bf16 values, cap <= 4096): (tot, smax, argpos) of
    `affine_scan_argmax_plain(..., packed=True)`."""
    _check_scan(pts, starts, counts, mmat, out_dtype)
    if not packed_argmax(out_dtype, cap):
        raise ValueError("the packed argmax (K5) needs bf16 values and a cap "
                         f"of at most {PACKED_MAX_CAP}")
    if pts.device.type == "cpu":
        return affine_scan_argmax_plain(pts, starts, counts, mmat, cap,
                                        out_dtype, packed=True)
    out = _scan_argmax(pts, starts, counts, mmat, cap, out_dtype, True)
    affine_scan_argmax_packed.launches += 1
    return out


affine_scan_argmax_packed.launches = 0


# ---------------------------------------------------------------------------
# K6: d(mmat) by each cell's argmax row (the training backward)
# ---------------------------------------------------------------------------

def _check_bwd(pts, argpos, d_smax, counts, out_dtype):
    if pts.dtype != torch.float32 or pts.dim() != 2 \
            or not 1 <= pts.shape[1] <= 8:
        raise ValueError("pts must be a (N, A) float32 tensor, A <= 8")
    if argpos.dtype != torch.int32 or argpos.dim() != 2 \
            or d_smax.shape != argpos.shape:
        raise ValueError("argpos (ncells, C) int32 and d_smax of its shape")
    if counts.dtype != torch.int32 or counts.shape != argpos.shape[:1]:
        raise ValueError("counts must be (ncells,) int32")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported out_dtype {out_dtype}")


def affine_bwd_dmmat_plain(pts, argpos, d_smax, counts, out_dtype):
    """PyTorch version of K6: d_mmat (A, C) float32, the layout of mmat
    (the transpose of the TPU kernel's (C, A) d_mmat_t):
        d_mmat[k, ch] = sum over occupied cells c of
                        round(d_smax[c, ch]) * round(pts[argpos[c, ch], k])
    with round() to out_dtype and f32 products and sums.  Empty cells and
    argpos -1 contribute nothing."""
    _check_bwd(pts, argpos, d_smax, counts, out_dtype)
    live = (counts > 0)[:, None] & (argpos >= 0)
    d = torch.where(live, d_smax.to(out_dtype).float(), 0.0)
    rows = pts.to(out_dtype).float()[argpos.clamp(min=0).long()]
    return torch.einsum("nc,nca->ac", d, rows)


def affine_bwd_dmmat(pts, argpos, d_smax, counts, out_dtype):
    """Wrapper of K6: `affine_bwd_dmmat_plain`'s (A, C) d_mmat, from the
    kernel for CUDA tensors (deterministic: no float atomics)."""
    _check_bwd(pts, argpos, d_smax, counts, out_dtype)
    if pts.device.type == "cpu":
        return affine_bwd_dmmat_plain(pts, argpos, d_smax, counts, out_dtype)
    d_smax = d_smax.to(out_dtype).contiguous()
    for name, t in (("pts", pts), ("argpos", argpos), ("d_smax", d_smax),
                    ("counts", counts)):
        _ext.require_cuda(t, name)
    ncells, width = argpos.shape
    a = pts.shape[1]
    partial = torch.empty(((ncells + 63) // 64, a, width),
                          dtype=torch.float32, device=pts.device)
    out = torch.empty((a, width), dtype=torch.float32, device=pts.device)
    fn = _ext.function("affine_bwd_dmmat")
    _ext.check(fn(pts.data_ptr(), argpos.data_ptr(), d_smax.data_ptr(),
                  counts.data_ptr(), partial.data_ptr(), out.data_ptr(),
                  ncells, a, width, int(out_dtype == torch.bfloat16),
                  _ext.stream_ptr(out)), "affine_bwd_dmmat")
    affine_bwd_dmmat.launches += 1
    return out


affine_bwd_dmmat.launches = 0


# ---------------------------------------------------------------------------
# The custom VJP of the scan (pallas_affine._make_scan_gather)
# ---------------------------------------------------------------------------

class ScanGather(torch.autograd.Function):
    """(tot, smax) of K2 with a gradient for mmat only.

    Forward runs K5 (bf16 with a cap of at most 4096) or K4 and keeps the
    argmax rows; backward routes each cell's d_smax to its first argmax row
    through K6.  Points, starts and counts get no gradient, and tot none
    either, so the mean of a cell is a constant, as in the JAX package.
    `reference=True` runs the plain versions."""

    @staticmethod
    def forward(ctx, pts, starts, counts, mmat, cap, out_dtype, reference):
        packed = packed_argmax(out_dtype, cap)
        if reference:
            tot, smax, argpos = affine_scan_argmax_plain(
                pts, starts, counts, mmat, cap, out_dtype, packed)
        elif packed:
            tot, smax, argpos = affine_scan_argmax_packed(
                pts, starts, counts, mmat, cap, out_dtype)
        else:
            tot, smax, argpos = affine_scan_argmax_pair(
                pts, starts, counts, mmat, cap, out_dtype)
        ctx.save_for_backward(pts, argpos, counts)
        ctx.out_dtype, ctx.reference = out_dtype, reference
        ctx.mark_non_differentiable(tot)
        return tot, smax

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_tot, d_smax):
        pts, argpos, counts = ctx.saved_tensors
        fn = affine_bwd_dmmat_plain if ctx.reference else affine_bwd_dmmat
        d_mmat = fn(pts, argpos, d_smax.contiguous(), counts, ctx.out_dtype)
        return None, None, None, d_mmat, None, None, None


def scan_gather(pts, starts, counts, mmat, cap, out_dtype, *,
                reference: bool = False):
    """The canvas's scan: `ScanGather` (K4/K5 + K6) when autograd records a
    gradient for mmat, else serving's K2 (or its plain version)."""
    if torch.is_grad_enabled() and mmat.requires_grad:
        return ScanGather.apply(pts, starts, counts, mmat, cap, out_dtype,
                                reference)
    fn = affine_scan_gather_plain if reference else affine_scan_gather
    return fn(pts, starts, counts, mmat, cap, out_dtype)
