"""K1: ascending sort of int32 keys (the B=1 packed cell/index keys), and
K10: lexicographic sort of int32 (hi, lo) pairs (the B=1 (cell, index)
pairs of grids whose packed key overflows 31 bits).

Counterparts of `gndnet_tpu.ops.pallas_sort.sort_padded_i32` /
`bitonic_sort_i32` and `sort2_padded_i32` / `bitonic_sort2_i32`.
`sort_i32` and `sort2_i32` are the wrappers: for CUDA tensors they launch
the bitonic networks of `csrc/bitonic_sort.cu` and `csrc/bitonic_sort2.cu`;
for CPU tensors they run `sort_i32_plain` and `sort2_i32_plain`, the same
networks written in PyTorch.  Unlike the JAX entries there is no library
fallback below 256 keys: every CUDA call goes through the kernel.
"""

from __future__ import annotations

import torch

from gndnet_tpu_torch import _ext

INT32_MAX = 2**31 - 1
MAX_KEYS = 1 << 30


def padded_size(n: int) -> int:
    """The power of two (>= 2) the network sorts for n keys."""
    return 1 << max(n - 1, 1).bit_length()


def _check(x: torch.Tensor) -> None:
    if x.dtype != torch.int32 or x.dim() != 1:
        raise ValueError(f"expected a 1-D int32 tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if padded_size(x.numel()) > MAX_KEYS:
        raise ValueError(f"{x.numel()} keys exceed the 2^30-key limit")


def _padded(x: torch.Tensor) -> torch.Tensor:
    buf = torch.full((padded_size(x.numel()),), INT32_MAX, dtype=torch.int32,
                     device=x.device)
    buf[:x.numel()] = x
    return buf


def _network(buf: torch.Tensor) -> torch.Tensor:
    """The bitonic network of the kernels over a power-of-two tensor of
    integer keys, one vectorised compare-exchange per stage."""
    m = buf.numel()
    low = torch.arange(m, device=buf.device)
    k = 2
    while k <= m:
        j = k // 2
        while j >= 1:
            pairs = buf.view(m // (2 * j), 2, j)
            lo, hi = pairs[:, 0], pairs[:, 1]
            asc = (low.view(m // (2 * j), 2, j)[:, 0] & k) == 0
            small, big = torch.minimum(lo, hi), torch.maximum(lo, hi)
            buf = torch.stack([torch.where(asc, small, big),
                               torch.where(asc, big, small)], 1).reshape(m)
            j //= 2
        k *= 2
    return buf


def sort_i32_plain(x: torch.Tensor) -> torch.Tensor:
    """K1's network in PyTorch, on any device."""
    _check(x)
    if x.numel() == 0:
        return x.clone()
    return _network(_padded(x))[:x.numel()]


def sort_i32(x: torch.Tensor) -> torch.Tensor:
    """Ascending sort of a 1-D int32 tensor of any length.  Pads to a power
    of two with INT32_MAX; equal keys are allowed."""
    _check(x)
    if x.device.type == "cpu":
        return sort_i32_plain(x)
    _ext.require_cuda(x, "keys")
    n = x.numel()
    if n == 0:
        return x.clone()
    buf = _padded(x)
    fn = _ext.function("bitonic_sort_i32")
    _ext.check(fn(buf.data_ptr(), buf.numel(), _ext.stream_ptr(buf)),
               "bitonic_sort_i32")
    sort_i32.launches += 1
    return buf[:n]


sort_i32.launches = 0


# ---------------------------------------------------------------------------
# K10: (hi, lo) pairs
# ---------------------------------------------------------------------------

_WORD = 2**32
_BIAS = 2**31
_PAD_PAIR = INT32_MAX * _WORD + INT32_MAX + _BIAS   # (INT32_MAX, INT32_MAX)
_SORT2_TILE = 4096   # keys a block sorts in shared memory (bitonic_sort2.cu)


def _check2(hi: torch.Tensor, lo: torch.Tensor) -> None:
    _check(hi)
    _check(lo)
    if hi.shape != lo.shape or hi.device != lo.device:
        raise ValueError(f"hi and lo differ: {tuple(hi.shape)} on "
                         f"{hi.device}, {tuple(lo.shape)} on {lo.device}")


def pack_pairs(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The kernel's order-preserving int64 key of each pair: hi in the top
    word, lo + 2^31 in the low one, so the signed int64 order is the
    lexicographic (hi, lo) order."""
    return hi.long() * _WORD + (lo.long() + _BIAS)


def unpack_pairs(key: torch.Tensor):
    hi = torch.div(key, _WORD, rounding_mode="floor")
    return hi.to(torch.int32), (key - hi * _WORD - _BIAS).to(torch.int32)


def sort2_i32_plain(hi: torch.Tensor, lo: torch.Tensor):
    """K10's network in PyTorch, on any device: the packed int64 keys,
    padded with the pair (INT32_MAX, INT32_MAX), through K1's network."""
    _check2(hi, lo)
    n = hi.numel()
    if n == 0:
        return hi.clone(), lo.clone()
    buf = torch.full((padded_size(n),), _PAD_PAIR, dtype=torch.int64,
                     device=hi.device)
    buf[:n] = pack_pairs(hi, lo)
    return unpack_pairs(_network(buf)[:n])


def sort2_i32(hi: torch.Tensor, lo: torch.Tensor):
    """Ascending lexicographic sort of two 1-D int32 tensors of any length
    as (hi, lo) pairs: `np.lexsort((lo, hi))`, a stable sort by hi when lo
    is the stream iota.  Any values are allowed, INT32_MIN and INT32_MAX
    included, and lo need not be unique.  Returns (hi_sorted, lo_sorted)."""
    _check2(hi, lo)
    if hi.device.type == "cpu":
        return sort2_i32_plain(hi, lo)
    _ext.require_cuda(hi, "hi")
    _ext.require_cuda(lo, "lo")
    n = hi.numel()
    if n == 0:
        return hi.clone(), lo.clone()
    m = padded_size(n)
    hi_out, lo_out = torch.empty_like(hi), torch.empty_like(lo)
    keys = torch.empty((m if m > _SORT2_TILE else 0,), dtype=torch.int64,
                       device=hi.device)
    fn = _ext.function("bitonic_sort2_i32")
    _ext.check(fn(hi.data_ptr(), lo.data_ptr(),
                  keys.data_ptr() if keys.numel() else None,
                  hi_out.data_ptr(), lo_out.data_ptr(), n, m,
                  _ext.stream_ptr(hi)), "bitonic_sort2_i32")
    sort2_i32.launches += 1
    return hi_out, lo_out


sort2_i32.launches = 0
