"""K1: ascending sort of int32 keys (the B=1 packed cell/index keys), and
K10: lexicographic sort of int32 (hi, lo) pairs (the B=1 (cell, index)
pairs of grids whose packed key overflows 31 bits).

Counterparts of `gndnet_tpu.ops.pallas_sort.sort_padded_i32` /
`bitonic_sort_i32` and `sort2_padded_i32` / `bitonic_sort2_i32`.
`sort_i32` and `sort2_i32` are the wrappers.  For CUDA tensors they choose
the kernel by length alone: up to `RADIX_MAX_I32` keys / `RADIX_MAX_PAIRS`
pairs the stable LSD radix sort of `csrc/cluster_radix_sort.cu`, one
launch of one thread-block cluster that holds every key in its shared
memory; above that the bitonic networks of `csrc/bitonic_sort.cu` and
`csrc/bitonic_sort2.cu`.  Every shipped config's B=1 scan (102 400 keys)
takes the radix kernel.  For CPU tensors they run `sort_i32_plain` and
`sort2_i32_plain`, which follow the same rule with the same algorithms
written in PyTorch (`radix_sort_plain`, `radix_sort2_plain`, `_network`).
A sort's output is unique, so all of them agree to the bit.  Unlike the
JAX entries there is no library fallback below 256 keys: every CUDA call
goes through a kernel.
"""

from __future__ import annotations

import torch

from gndnet_tpu_torch import _ext

INT32_MAX = 2**31 - 1
MAX_KEYS = 1 << 30
# What one cluster of 16 CTAs holds in shared memory (cluster_radix_sort.cu:
# 26 744 int32 keys or 13 372 pairs a CTA).
RADIX_MAX_I32 = 16 * 26_744
RADIX_MAX_PAIRS = 16 * 13_372
_SIGN = 0x80000000
_RANK_CHUNK = 4096   # keys per one-hot block in `_bucket_ranks`


def padded_size(n: int) -> int:
    """The power of two (>= 2) the network sorts for n keys."""
    return 1 << max(n - 1, 1).bit_length()


def _check(x: torch.Tensor) -> None:
    if x.dtype != torch.int32 or x.dim() != 1:
        raise ValueError(f"expected a 1-D int32 tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if padded_size(x.numel()) > MAX_KEYS:
        raise ValueError(f"{x.numel()} keys exceed the 2^30-key limit")


# ---------------------------------------------------------------------------
# the cluster radix sort's algorithm in PyTorch
# ---------------------------------------------------------------------------

def radix_word(x: torch.Tensor) -> torch.Tensor:
    """The kernel's key transform of one int32 word, uint32(x) ^ 2^31, as
    int64 in [0, 2^32): its unsigned order is the signed order of x."""
    return (x.long() & 0xFFFFFFFF) ^ _SIGN


def _bucket_ranks(d: torch.Tensor) -> torch.Tensor:
    """Stable rank of every key within its digit's bucket (how many earlier
    keys share its digit), from a one-hot cumsum in blocks."""
    ranks = torch.empty_like(d)
    seen = torch.zeros(256, dtype=torch.long, device=d.device)
    bins = torch.arange(256, device=d.device)[:, None]
    for s in range(0, d.numel(), _RANK_CHUNK):
        blk = d[s:s + _RANK_CHUNK]
        # (256, block) one-hot, summed along the keys; int16 holds a count
        # within one block of 4096 keys
        counts = (bins == blk).to(torch.int16).cumsum(1, dtype=torch.int16)
        ranks[s:s + _RANK_CHUNK] = (seen[blk] + counts.gather(0, blk[None])[0]
                                    - 1)
        seen += counts[:, -1]
    return ranks


def _radix_order(words: list, first_shift: int = 0) -> torch.Tensor:
    """The kernel's stable LSD radix sort of keys given as 32-bit words
    (int64 in [0, 2^32)), least significant first: 8-bit digits from bit
    `first_shift` up (a digit never straddles two words: pairs start at 0
    or 32), a digit where one bucket holds every key skipped, each pass a
    stable counting sort.  Returns the sorting permutation."""
    n = words[0].numel()
    order = torch.arange(n, device=words[0].device)
    for shift in range(first_shift, 32 * len(words), 8):
        d = (words[shift // 32][order] >> (shift % 32)) & 255
        counts = torch.bincount(d, minlength=256)
        if int(counts.max()) == n:
            continue
        dest = (torch.cumsum(counts, 0) - counts)[d] + _bucket_ranks(d)
        moved = torch.empty_like(order)
        moved[dest] = order
        order = moved
    return order


def _in_order(word: torch.Tensor, mask: int) -> bool:
    return bool(((word[1:] & mask) >= (word[:-1] & mask)).all())


def radix_sort_plain(x: torch.Tensor) -> torch.Tensor:
    """K1's cluster radix sort in PyTorch, on any device: up to 4 passes
    over radix_word(x).  Keys already in order in their low
    bit_length(n - 1) bits (where cell_stream's packed keys hold the stream
    index) sort by the bits above only, as in the kernel."""
    _check(x)
    if x.numel() == 0:
        return x.clone()
    word = radix_word(x)
    low = (x.numel() - 1).bit_length()
    first = low if _in_order(word, (1 << low) - 1) else 0
    return x[_radix_order([word], first)]


def radix_sort2_plain(hi: torch.Tensor, lo: torch.Tensor):
    """K10's cluster radix sort in PyTorch, on any device: up to 8 passes
    over the 64-bit key radix_word(hi) << 32 | radix_word(lo), its low word
    first.  Where lo is already in non-decreasing order (the stream iota),
    lo's passes would keep every pair in place, so they are skipped, as in
    the kernel."""
    _check2(hi, lo)
    if hi.numel() == 0:
        return hi.clone(), lo.clone()
    low = radix_word(lo)
    first = 32 if _in_order(low, 0xFFFFFFFF) else 0
    order = _radix_order([low, radix_word(hi)], first)
    return hi[order], lo[order]


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

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
    """K1 in PyTorch, on any device, by the wrapper's size rule: the radix
    sort up to RADIX_MAX_I32 keys, the bitonic network above."""
    _check(x)
    if x.numel() <= RADIX_MAX_I32:
        return radix_sort_plain(x)
    return _network(_padded(x))[:x.numel()]


def sort_i32(x: torch.Tensor) -> torch.Tensor:
    """Ascending sort of a 1-D int32 tensor of any length; equal keys and
    both int32 extremes are allowed."""
    _check(x)
    if x.device.type == "cpu":
        return sort_i32_plain(x)
    _ext.require_cuda(x, "keys")
    n = x.numel()
    if n == 0:
        return x.clone()
    stream = _ext.stream_ptr(x)
    if n <= RADIX_MAX_I32:
        out = torch.empty_like(x)
        _ext.check(_ext.function("cluster_radix_sort_i32")(
            x.data_ptr(), out.data_ptr(), n, stream), "cluster_radix_sort_i32")
    else:
        out = _padded(x)
        _ext.check(_ext.function("bitonic_sort_i32")(
            out.data_ptr(), out.numel(), stream), "bitonic_sort_i32")
        out = out[:n]
    sort_i32.launches += 1
    return out


sort_i32.launches = 0


# ---------------------------------------------------------------------------
# K10: (hi, lo) pairs
# ---------------------------------------------------------------------------

_WORD = 2**32
_BIAS = 2**31
_PAD_PAIR = INT32_MAX * _WORD + INT32_MAX + _BIAS   # (INT32_MAX, INT32_MAX)


def _check2(hi: torch.Tensor, lo: torch.Tensor) -> None:
    _check(hi)
    _check(lo)
    if hi.shape != lo.shape or hi.device != lo.device:
        raise ValueError(f"hi and lo differ: {tuple(hi.shape)} on "
                         f"{hi.device}, {tuple(lo.shape)} on {lo.device}")


def pack_pairs(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The bitonic kernel's order-preserving int64 key of each pair: hi in
    the top word, lo + 2^31 in the low one, so the signed int64 order is
    the lexicographic (hi, lo) order."""
    return hi.long() * _WORD + (lo.long() + _BIAS)


def unpack_pairs(key: torch.Tensor):
    hi = torch.div(key, _WORD, rounding_mode="floor")
    return hi.to(torch.int32), (key - hi * _WORD - _BIAS).to(torch.int32)


def sort2_i32_plain(hi: torch.Tensor, lo: torch.Tensor):
    """K10 in PyTorch, on any device, by the wrapper's size rule: the radix
    sort up to RADIX_MAX_PAIRS pairs; above, the packed int64 keys, padded
    with the pair (INT32_MAX, INT32_MAX), through K1's network."""
    _check2(hi, lo)
    n = hi.numel()
    if n <= RADIX_MAX_PAIRS:
        return radix_sort2_plain(hi, lo)
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
    hi_out, lo_out = torch.empty_like(hi), torch.empty_like(lo)
    stream = _ext.stream_ptr(hi)
    if n <= RADIX_MAX_PAIRS:
        _ext.check(_ext.function("cluster_radix_sort2_i32")(
            hi.data_ptr(), lo.data_ptr(), hi_out.data_ptr(),
            lo_out.data_ptr(), n, stream), "cluster_radix_sort2_i32")
    else:
        m = padded_size(n)
        keys = torch.empty((m,), dtype=torch.int64, device=hi.device)
        _ext.check(_ext.function("bitonic_sort2_i32")(
            hi.data_ptr(), lo.data_ptr(), keys.data_ptr(), hi_out.data_ptr(),
            lo_out.data_ptr(), n, m, stream), "bitonic_sort2_i32")
    sort2_i32.launches += 1
    return hi_out, lo_out


sort2_i32.launches = 0
