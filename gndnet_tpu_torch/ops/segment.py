"""K7: suffix segmented max or sum over a cell-sorted stream.

Counterpart of `gndnet_tpu.ops.pallas_segment`: `suffix_segment_reduce`
(the wrapper: the kernel of `csrc/suffix_segment.cu` for CUDA tensors, the
plain version for CPU tensors, with a launch counter) and
`segment_reduce_canvas`.  Every row i receives

    out[i, :] = reduce(x[j, :] for j >= i while cell[j] == cell[i])

so a run's first row holds the run's full reduction.  `cell` may be any
non-decreasing int32 stream (the sorted frontend also reduces a flipped
stream of negated ids); no value is reserved.
"""

from __future__ import annotations

import torch

from gndnet_tpu_torch import _ext

_MAX_C = 2048      # columns the kernel takes (csrc/suffix_segment.cu MAX_C)
_STAGE = 16384     # floats a block stages (suffix_segment.cu STAGE_FLOATS)


def _check(x: torch.Tensor, cell: torch.Tensor, op: str, chunk: int) -> None:
    """The JAX entry's checks (op, N % chunk), plus the types K7 takes:
    float32 for either op, bfloat16 for max."""
    if op not in ("max", "sum"):
        raise ValueError(f"op must be 'max' or 'sum', got {op!r}")
    if x.dim() != 2:
        raise ValueError(f"x must be (N, C), got {tuple(x.shape)}")
    n, width = x.shape
    if n % chunk != 0:
        raise ValueError(f"N={n} must be divisible by chunk={chunk}")
    if cell.dtype != torch.int32 or tuple(cell.shape) != (n,):
        raise ValueError("cell must be an (N,) int32 tensor")
    if not (x.dtype == torch.float32
            or (x.dtype == torch.bfloat16 and op == "max")):
        raise ValueError(f"{op} over {x.dtype}: K7 takes float32, and "
                         "bfloat16 for max")
    if width > _MAX_C:
        raise ValueError(f"C={width} columns; K7 takes at most {_MAX_C}")


def tile_rows(width: int) -> int:
    """Rows per block of the kernel: 256 at 64 columns and more, up to
    1024 for narrow streams (fewer tiles to carry runs across)."""
    return max(256, min(1024, 16384 // width))


def scan_layout(width: int):
    """The kernel's (tile rows T, slices per tile S, slice rows L); K8
    (csrc/prefix_segment.cu, `affine_aux.k8_layout`) tiles its prefix scan
    the same way, forwards."""
    tile = tile_rows(width)
    per = -(-tile // max(1, min(_THREADS // width, tile)))
    return tile, -(-tile // per), per


_THREADS = 256     # threads per block (csrc/suffix_segment.cu THREADS)


def suffix_segment_reduce_plain(x: torch.Tensor, cell: torch.Tensor,
                                op: str = "max",
                                chunk: int = 1024) -> torch.Tensor:
    """K7 in PyTorch on any device, in the kernel's order, so its float32
    sums equal the kernel's to the bit: each L-row slice of each T-row
    tile backwards; slice heads backwards, each run carried into the
    slice before it and added to that slice's last run; tile heads
    backwards, likewise.  (A sum in another order moves the canvas by a
    few 1e-6, which the SegNet's argmax routing can turn into 1e-3 of
    elevation.)  Works in float32; max is exact in any order."""
    _check(x, cell, op, chunk)
    n, width = x.shape
    if n == 0:
        return x.clone()
    dev = x.device
    comb = torch.maximum if op == "max" else torch.add
    tile, nsl, per = scan_layout(width)
    nt = -(-n // tile)
    # the row at (tile, slice, position); n where no row is (past the
    # tile or the stream), which reads zeros and joins no run
    p = torch.arange(nsl * per, device=dev)
    rows = torch.arange(nt, device=dev)[:, None] * tile + p
    rows = torch.where((p < tile) & (rows < n), rows, n).view(nt, nsl, per)
    real = rows < n
    same = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    same[:n - 1] = cell[1:] == cell[:-1]        # row r+1 is in r's run
    ids = torch.cat([cell, cell[-1:]])
    vals = torch.cat([x.float(), torch.zeros((1, width), device=dev)])

    # pass 1: slices backwards, then the slice carries inside each tile
    out = torch.empty((nt, nsl, per, width), device=dev)
    v = vals[rows[:, :, -1]]
    out[:, :, -1] = v
    for k in range(per - 2, -1, -1):
        xv = vals[rows[:, :, k]]
        join = same[rows[:, :, k]] & real[:, :, k + 1]
        v = torch.where(join[..., None], comb(xv, v), xv)
        out[:, :, k] = v
    first = rows[:, :, 0]
    nxt_first = torch.cat([first[:, 1:], torch.full_like(first[:, :1], n)],
                          dim=1)
    cont = same[rows[:, :, -1]] & (nxt_first < n)
    whole = ids[first] == ids[rows[:, :, -1]]
    carry = torch.empty((nt, nsl, width), device=dev)
    run = torch.zeros((nt, width), device=dev)
    for s in range(nsl - 1, -1, -1):
        carry[:, s] = run
        head = out[:, s, 0]
        run = torch.where((cont[:, s] & whole[:, s])[:, None],
                          comb(head, run), head)
    fix = cont[..., None] & real & (ids[rows] == ids[nxt_first][..., None])
    out = torch.where(fix[..., None], comb(out, carry[:, :, None]), out)

    # passes 2 and 3: tile heads backwards, then each tile's last run
    starts = torch.arange(nt, device=dev) * tile
    last = torch.clamp(starts + tile, max=n) - 1
    tcont = torch.zeros(nt, dtype=torch.bool, device=dev)
    tcont[:-1] = cell[last[:-1]] == cell[starts[1:]]
    twhole = cell[starts] == cell[last]
    tcarry = torch.empty((nt, width), device=dev)
    nxt = torch.zeros(width, device=dev)
    for t in range(nt - 1, -1, -1):
        tcarry[t] = nxt
        nxt = torch.where(tcont[t] & twhole[t], comb(run[t], nxt), run[t])
    tnext = torch.cat([cell[starts[1:]], cell[-1:]])
    fix = tcont[:, None, None] & real & (ids[rows] == tnext[:, None, None])
    out = torch.where(fix[..., None], comb(out, tcarry[:, None, None]), out)
    return out.reshape(-1, width)[real.reshape(-1)].to(x.dtype)


def suffix_segment_reduce(x: torch.Tensor, cell: torch.Tensor,
                          op: str = "max",
                          chunk: int = 1024) -> torch.Tensor:
    """Wrapper of K7: (N, C) x over the runs of a non-decreasing (N,) int32
    `cell` -> (N, C) in x's type, in one kernel launch (and one memset of
    its flags).  `chunk` only keeps the JAX entry's N % chunk rule; the
    kernel is not tied to it."""
    _check(x, cell, op, chunk)
    if x.device.type == "cpu":
        return suffix_segment_reduce_plain(x, cell, op, chunk)
    _ext.require_cuda(x, "x")
    _ext.require_cuda(cell, "cell")
    n, width = x.shape
    out = torch.empty_like(x)
    if n == 0 or width == 0:
        return out
    tile = tile_rows(width)
    cols = min(width, _STAGE // tile)        # columns a block stages
    nt = -(-n // tile)
    # heads and inclusive values (2, nt, C) f32, then the ticket and one
    # flag per (column chunk, tile), which the entry zeroes
    scratch = torch.empty(2 * nt * width + 1 + -(-width // cols) * nt,
                          dtype=torch.int32, device=x.device)
    fn = _ext.function("suffix_segment_reduce")
    _ext.check(fn(x.data_ptr(), cell.data_ptr(), out.data_ptr(),
                  scratch.data_ptr(), n, width, tile, cols,
                  int(op == "max"), int(x.dtype == torch.bfloat16),
                  _ext.stream_ptr(out)), "suffix_segment_reduce")
    suffix_segment_reduce.launches += 1
    return out


suffix_segment_reduce.launches = 0


def segment_reduce_canvas(point_feats: torch.Tensor, cell: torch.Tensor,
                          num_cells: int, op: str = "max",
                          chunk: int = 1024, reference: bool = False):
    """Per-cell reduction of a sorted stream whose ids lie in [0, num_cells]
    (num_cells: the drop segment) into a dense (num_cells, C) map: returns
    (canvas, counts (num_cells,) int32), empty cells zero.
    `reference=True` takes K7's plain version."""
    reduce = (suffix_segment_reduce_plain if reference
              else suffix_segment_reduce)
    reduced = reduce(point_feats, cell, op, chunk)
    starts = torch.searchsorted(
        cell, torch.arange(num_cells + 1, dtype=cell.dtype,
                           device=cell.device), side="left")
    counts = (starts[1:] - starts[:-1]).to(torch.int32)
    rows = reduced[starts[:-1].clamp(0, point_feats.shape[0] - 1)]
    canvas = torch.where((counts > 0)[:, None], rows,
                         torch.zeros((), dtype=rows.dtype, device=rows.device))
    return canvas.to(point_feats.dtype), counts
