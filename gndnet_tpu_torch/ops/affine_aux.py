"""K8 (the row-major fused segmented scan) and K9 (the segmented prefix-max
broadcast), off the model path.

Counterparts of `gndnet_tpu.ops.pallas_affine.affine_segment_scan`, K2's
retained row-major predecessor, and `segment_broadcast_t`, a general
segmented-broadcast utility.  The model calls neither; the affine stage
profile (`gndnet_tpu_torch.profile_affine`) does.  They live here and not
in `ops/affine.py`, which holds the kernels of the model path.  Each wrapper
launches its hand-written kernel (`csrc/prefix_segment.cu`: one launch a
call, runs carried across tiles by a forward decoupled look-back) for CUDA
tensors and runs its plain PyTorch version for CPU tensors; the plain
versions also run on the card as the kernels' oracle.  `k8_layout` and
`k9_layout` are the kernels' launch geometry and scratch sizes.
"""

from __future__ import annotations

import torch

from gndnet_tpu_torch import _ext
from gndnet_tpu_torch.ops import affine, segment

_MAX_W = 2048      # scan columns the kernel takes (prefix_segment.cu MAX_W)
K8_CHANNELS = 64   # maxima a K8 block (K8_CHANNELS)
_THREADS = 256     # threads a block (THREADS)
K9_ROWS = 1024     # rows of a K9 tile (BC_ROWS)
K9_GROUP = 8       # channels of a K9 block, a warp each (BC_WARPS)
_EPOCHS = 1 << 30  # a flag holds epoch << 2 | status in 32 bits

_sync_state: dict = {}   # device -> [ticket and flags (int32), last epoch]


def k8_layout(n: int, width: int):
    """K8's launch geometry for n rows of `width` = 4 + C scan columns:
    (tile rows T, slice rows L, channel chunks, tiles, shared-memory bytes
    a block).  T and L are `segment.scan_layout`'s, the order of the sums
    that the plain version repeats; a block takes one tile and a chunk of
    K8_CHANNELS maxima (chunk 0 also the 4 sums), a thread 4 channels of
    one segment of the tile's rows."""
    tile, slices, per = segment.scan_layout(width)
    smem = 4 * (20 * tile + 8 * slices + 12 * _THREADS + 8 * K8_CHANNELS
                + 2 * (4 + K8_CHANNELS)) + 4 * (tile // 32 + 1 + tile + 1)
    return tile, per, -(-(width - 4) // K8_CHANNELS), -(-n // tile), smem


def k9_layout(n: int, width: int):
    """K9's launch geometry for a (width, n) table: (tile rows, channels a
    block, channel groups, tiles); a block is one tile of one group, a
    warp per channel."""
    return K9_ROWS, K9_GROUP, -(-width // K9_GROUP), -(-n // K9_ROWS)


def _sync(device, flags: int):
    """The device's ticket and `flags` flags (int32; K8 and K9 share them)
    and this call's epoch.  The kernel's last block puts the ticket back to
    0 and each flag carries its call's epoch, so no call clears them: calls
    on one device must be ordered on one stream.  Made anew, zeroed, when
    too small or when the epochs run out."""
    dev = torch.device(device)
    state = _sync_state.get(dev)
    if state is None or state[0].numel() < 1 + flags \
            or state[1] + 1 >= _EPOCHS:
        size = 1 + flags if state is None else max(1 + flags,
                                                   state[0].numel())
        state = _sync_state[dev] = [
            torch.zeros(size, dtype=torch.int32, device=dev), 0]
    state[1] += 1
    return state[0], state[1]


def _check_cell(cell: torch.Tensor, n: int, chunk: int) -> None:
    if cell.dtype != torch.int32 or tuple(cell.shape) != (n,):
        raise ValueError("cell_sorted must be an (N,) int32 tensor")
    if n % chunk != 0:
        raise ValueError(f"N={n} must be divisible by chunk={chunk}")


def _check_scan8(cell, pts8, mmat8, out_dtype, chunk):
    if pts8.dtype != torch.float32 or pts8.dim() != 2 or pts8.shape[1] != 8:
        raise ValueError("pts8 must be an (N, 8) float32 tensor")
    if mmat8.dtype != torch.float32 or mmat8.dim() != 2 \
            or mmat8.shape[0] != 8:
        raise ValueError("mmat8 must be an (8, C) float32 tensor")
    if 4 + mmat8.shape[1] > _MAX_W:
        raise ValueError(f"C={mmat8.shape[1]}; the kernel takes at most "
                         f"{_MAX_W - 4} channels")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported out_dtype {out_dtype}")
    _check_cell(cell, pts8.shape[0], chunk)


def _check_broadcast(cell, vals_t, chunk):
    if vals_t.dtype != torch.float32 or vals_t.dim() != 2:
        raise ValueError("vals_t must be a (C, N) float32 tensor")
    if vals_t.shape[0] > _MAX_W:
        raise ValueError(f"C={vals_t.shape[0]}; the kernel takes at most "
                         f"{_MAX_W} channels")
    _check_cell(cell, vals_t.shape[1], chunk)


def _prefix_scan_plain(x: torch.Tensor, cell: torch.Tensor,
                       nsum: int) -> torch.Tensor:
    """K8's order in PyTorch, so float32 sums equal the kernel's to the
    bit: each L-row slice of each T-row tile forwards; slice tails
    forwards, each run carried into the slice after it and added on the
    left of that slice's first run; tile tails forwards, likewise (the
    kernel's look-back folds the same tails from the left).  x (N, W)
    float32: columns < nsum are summed, the rest maxed.  Returns the
    inclusive prefix of every row's run."""
    n, width = x.shape
    dev = x.device
    is_sum = torch.arange(width, device=dev) < nsum

    def comb(a, b):
        """a the earlier rows."""
        return torch.where(is_sum, a + b, torch.maximum(a, b))

    tile, nsl, per = segment.scan_layout(width)
    nt = -(-n // tile)
    # the row at (tile, slice, position); n where no row is (past the tile
    # or the stream), which reads zeros and joins no run
    p = torch.arange(nsl * per, device=dev)
    rows = torch.arange(nt, device=dev)[:, None] * tile + p
    rows = torch.where((p < tile) & (rows < n), rows, n).view(nt, nsl, per)
    real = rows < n
    same = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    same[1:n] = cell[1:] == cell[:-1]           # row r is in r-1's run
    ids = torch.cat([cell, cell[-1:]])
    vals = torch.cat([x, torch.zeros((1, width), device=dev)])

    # pass 1: slices forwards, then the slice carries inside each tile
    out = torch.empty((nt, nsl, per, width), device=dev)
    v = vals[rows[:, :, 0]]
    out[:, :, 0] = v
    for k in range(1, per):
        xv = vals[rows[:, :, k]]
        v = torch.where(same[rows[:, :, k]][..., None], comb(v, xv), xv)
        out[:, :, k] = v
    last_k = (real.sum(-1) - 1).clamp(min=0)
    tail = out.gather(2, last_k[..., None, None].expand(
        nt, nsl, 1, width))[:, :, 0]
    first = rows[:, :, 0]
    cont = torch.zeros((nt, nsl), dtype=torch.bool, device=dev)
    cont[:, 1:] = same[first[:, 1:]]
    whole = ids[first] == ids[rows.gather(2, last_k[..., None])[..., 0]]
    carry = torch.empty((nt, nsl, width), device=dev)
    run = torch.zeros((nt, width), device=dev)
    for s in range(nsl):
        carry[:, s] = run
        nxt = torch.where((cont[:, s] & whole[:, s])[:, None],
                          comb(run, tail[:, s]), tail[:, s])
        run = torch.where(real[:, s, :1], nxt, run)
    fix = cont[..., None] & real & (ids[rows] == ids[first - 1][..., None])
    out = torch.where(fix[..., None], comb(carry[:, :, None], out), out)

    # passes 2 and 3: tile tails forwards, then each tile's first run
    starts = torch.arange(nt, device=dev) * tile
    last = torch.clamp(starts + tile, max=n) - 1
    tcont = torch.zeros(nt, dtype=torch.bool, device=dev)
    tcont[1:] = cell[starts[1:] - 1] == cell[starts[1:]]
    twhole = cell[starts] == cell[last]
    tcarry = torch.empty((nt, width), device=dev)
    nxt = torch.zeros(width, device=dev)
    for t in range(nt):
        tcarry[t] = nxt
        nxt = torch.where(tcont[t] & twhole[t], comb(nxt, run[t]), run[t])
    tprev = cell[(starts - 1).clamp(min=0)]
    fix = tcont[:, None, None] & real & (ids[rows] == tprev[:, None, None])
    out = torch.where(fix[..., None], comb(tcarry[:, None, None], out), out)
    return out.reshape(-1, width)[real.reshape(-1)]


# ---------------------------------------------------------------------------
# K8: the row-major fused scan
# ---------------------------------------------------------------------------

def affine_segment_scan_plain(cell_sorted, pts8, mmat8, *,
                              out_dtype=torch.float32, chunk: int = 1024,
                              max_prefix: int | None = None):
    """PyTorch version of K8 on any device, in the kernel's order: per row
    a = round(fma chain of round(mmat8) x round(pts8)) (`affine`'s
    `_activations`), masked to -3e38 where kept = pts8[:, 3] is not > 0;
    then the inclusive prefix sums of pts8[:, :4] * kept and maxima of the
    masked activations over each run, every row complete."""
    _check_scan8(cell_sorted, pts8, mmat8, out_dtype, chunk)
    kept = pts8[:, 3:4]
    act = affine._activations(pts8, mmat8, out_dtype)
    x = torch.cat([pts8[:, :4] * kept,
                   torch.where(kept > 0, act, affine.BIG_NEG)], dim=1)
    if x.shape[0] == 0:
        return x[:, :4].clone(), x[:, 4:].to(out_dtype)
    out = _prefix_scan_plain(x, cell_sorted, 4)
    return out[:, :4].contiguous(), out[:, 4:].to(out_dtype)


def affine_segment_scan(cell_sorted, pts8, mmat8, *,
                        out_dtype=torch.float32, chunk: int = 1024,
                        max_prefix: int | None = None):
    """Wrapper of K8: fused sums, PFN product and masked max over a
    run-contiguous stream.

    Args:
      cell_sorted: (N,) int32 cell ids, equal ids contiguous.
      pts8: (N, 8) float32 [x, y, z, kept, extra..., 0 pad], column 3 the
        caller's kept mask (1.0 for rows that count, 0.0 otherwise).
      mmat8: (8, C) float32 per-point weights, row 3 zero.
      out_dtype: torch.float32 or torch.bfloat16, the type of run_max and
        of the product's rounding.
      chunk: the JAX entry's tiling; only its N % chunk rule is kept.
      max_prefix: the JAX kernel's shortened window, which leaves rows
        deeper than `max_prefix` into a run undefined.  The port computes
        every row's complete prefix, which equals the JAX kernel at every
        row that contract defines, so it is accepted and not used.
    Returns (run_tot (N, 4) float32, run_max (N, C) out_dtype): the
    inclusive prefix of each row's run.  One kernel launch for CUDA
    tensors; calls on one device must be ordered on one stream (they share
    a ticket and flags).
    """
    _check_scan8(cell_sorted, pts8, mmat8, out_dtype, chunk)
    if pts8.device.type == "cpu":
        return affine_segment_scan_plain(cell_sorted, pts8, mmat8,
                                         out_dtype=out_dtype, chunk=chunk,
                                         max_prefix=max_prefix)
    for name, t in (("cell_sorted", cell_sorted), ("pts8", pts8),
                    ("mmat8", mmat8)):
        _ext.require_cuda(t, name)
    n, width = pts8.shape[0], mmat8.shape[1]
    tot = torch.empty((n, 4), dtype=torch.float32, device=pts8.device)
    amax = torch.empty((n, width), dtype=out_dtype, device=pts8.device)
    if n == 0:
        return tot, amax
    tile, _, chunks, tiles, _ = k8_layout(n, 4 + width)
    # each tile's aggregate and inclusive value (2, tiles, 4 + C)
    scratch = torch.empty((2, tiles, 4 + width), dtype=torch.float32,
                          device=pts8.device)
    sync, epoch = _sync(pts8.device, chunks * tiles)
    fn = _ext.function("affine_segment_scan")
    _ext.check(fn(cell_sorted.data_ptr(), pts8.data_ptr(), mmat8.data_ptr(),
                  tot.data_ptr(), amax.data_ptr(), scratch.data_ptr(),
                  sync.data_ptr(), n, width, tile, epoch,
                  int(out_dtype == torch.bfloat16), _ext.stream_ptr(tot)),
               "affine_segment_scan")
    affine_segment_scan.launches += 1
    return tot, amax


affine_segment_scan.launches = 0


# ---------------------------------------------------------------------------
# K9: the segmented prefix-max broadcast
# ---------------------------------------------------------------------------

def segment_broadcast_t_plain(cell_sorted, vals_t, *, chunk: int = 2048):
    """PyTorch version of K9 on any device: log2(N) rounds of a segmented
    max with the row 2^k back (max is exact in any order)."""
    _check_broadcast(cell_sorted, vals_t, chunk)
    out = vals_t.clone()
    n = cell_sorted.shape[0]
    s = 1
    while s < n:
        ok = cell_sorted[s:] == cell_sorted[:-s]
        out = torch.cat([out[:, :s], torch.where(
            ok, torch.maximum(out[:, s:], out[:, :-s]), out[:, s:])], dim=1)
        s *= 2
    return out


def segment_broadcast_t(cell_sorted, vals_t, *, chunk: int = 2048):
    """Wrapper of K9: for (C, N) float32 `vals_t` over a run-contiguous
    (N,) int32 `cell_sorted`, every row gets the max of its run from the
    run's start to itself; with the payload at each run's first row and a
    dominated value elsewhere, every row holds its run's payload.  `chunk`
    only keeps the JAX entry's N % chunk rule.  One kernel launch for CUDA
    tensors (a warp per channel, lanes on consecutive rows); calls on one
    device must be ordered on one stream."""
    _check_broadcast(cell_sorted, vals_t, chunk)
    if vals_t.device.type == "cpu":
        return segment_broadcast_t_plain(cell_sorted, vals_t, chunk=chunk)
    _ext.require_cuda(cell_sorted, "cell_sorted")
    _ext.require_cuda(vals_t, "vals_t")
    width, n = vals_t.shape
    out = torch.empty_like(vals_t)
    if n == 0 or width == 0:
        return out
    _, _, groups, tiles = k9_layout(n, width)
    # each tile's aggregate and inclusive value (2, tiles, C)
    scratch = torch.empty((2, tiles, width), dtype=torch.float32,
                          device=vals_t.device)
    sync, epoch = _sync(vals_t.device, groups * tiles)
    fn = _ext.function("segment_broadcast_t")
    _ext.check(fn(cell_sorted.data_ptr(), vals_t.data_ptr(), out.data_ptr(),
                  scratch.data_ptr(), sync.data_ptr(), n, width, epoch,
                  _ext.stream_ptr(out)), "segment_broadcast_t")
    segment_broadcast_t.launches += 1
    return out


segment_broadcast_t.launches = 0
