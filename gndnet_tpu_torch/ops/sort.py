"""K1: ascending sort of int32 keys (the B=1 packed cell/index keys).

Counterpart of `gndnet_tpu.ops.pallas_sort.sort_padded_i32` /
`bitonic_sort_i32`.  `sort_i32` is the wrapper: for a CUDA tensor it
launches the bitonic network of `csrc/bitonic_sort.cu`; for a CPU tensor it
runs `sort_i32_plain`, the same network written in PyTorch.  Unlike the JAX
entry there is no library fallback below 256 keys: every CUDA call goes
through the kernel.
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


def sort_i32_plain(x: torch.Tensor) -> torch.Tensor:
    """The bitonic network of the kernel in PyTorch, one vectorised
    compare-exchange per stage, on any device."""
    _check(x)
    n = x.numel()
    if n == 0:
        return x.clone()
    buf = _padded(x)
    m = buf.numel()
    low = torch.arange(m, device=x.device)
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
    return buf[:n]


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
