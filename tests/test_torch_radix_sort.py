"""K1 and K10 as the cluster radix sort: its algorithm in PyTorch
(`radix_sort_plain`, `radix_sort2_plain`) and the CPU wrappers
(`sort_i32`, `sort2_i32`, which dispatch by size as the card does) against
the JAX package's `sort_padded_i32` and `bitonic_sort2_i32` /
`sort2_padded_i32` in interpret mode and against `np.sort` / `np.lexsort`.
Exact: a sort's output is unique."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gndnet_tpu.ops.pallas_sort import (bitonic_sort2_i32, sort2_padded_i32,
                                        sort_padded_i32)
from gndnet_tpu_torch.ops import sort

I32 = np.iinfo(np.int32)


def _keys(case: str) -> np.ndarray:
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    if case == "packed":
        # cell_stream's B=1 keys: local cell (drop id 257) * idxcap + index
        cells = rng.integers(0, 258, 700)
        return (cells * 1024 + np.arange(700)).astype(np.int32)
    if case == "extremes":
        # 60 duplicates each of INT32_MIN and INT32_MAX among small keys
        x = np.concatenate([rng.integers(-5, 5, 500), np.full(60, I32.max),
                            np.full(60, I32.min)])
        return rng.permutation(x).astype(np.int32)
    if case == "constant_digit":
        # byte 1 is the same in every key: the sort skips that pass
        x = rng.integers(-2**20, 2**20, 1000)
        return ((x & ~0xFF00) | 0x3700).astype(np.int32)
    n = int(case.split("_")[1])
    return rng.integers(I32.min, I32.max, n, endpoint=True).astype(np.int32)


INT32_CASES = ["packed", "extremes", "constant_digit", "random_0",
               "random_1", "random_2", "random_255", "random_257",
               "random_4097"]


@pytest.mark.parametrize("case", INT32_CASES)
def test_radix_sort_matches_pallas_and_numpy(case):
    x = _keys(case)
    want = np.sort(x)
    pallas = np.asarray(sort_padded_i32(jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(pallas, want)
    t = torch.from_numpy(x)
    for got in (sort.radix_sort_plain(t), sort.sort_i32(t),
                sort.sort_i32_plain(t)):
        assert got.dtype == torch.int32 and got.shape == (x.size,)
        np.testing.assert_array_equal(got.numpy(), want)


def _pairs(case: str):
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    if case == "cells_iota":
        # fine_grid's B=1 pairs: local cell (drop id 62 500), stream iota
        n = 3000
        return (rng.integers(0, 62_501, n).astype(np.int32),
                np.arange(n, dtype=np.int32))
    if case == "negative_hi":
        n = 1000
        return (rng.integers(-2**31, 0, n).astype(np.int32),
                rng.integers(-1000, 1000, n).astype(np.int32))
    if case == "extremes":
        hi = np.concatenate([rng.integers(-5, 5, 500), np.full(60, I32.max),
                             np.full(60, I32.min)]).astype(np.int32)
        lo = rng.integers(I32.min, I32.max, hi.size, endpoint=True)
        lo[::7] = I32.max
        lo[3::7] = I32.min
        perm = rng.permutation(hi.size)
        return hi[perm], lo[perm].astype(np.int32)
    if case == "repeated_lo":
        n = 800
        return (rng.integers(-50, 50, n).astype(np.int32),
                rng.integers(-3, 3, n).astype(np.int32))
    if case == "sorted_lo":
        # lo in non-decreasing order with repeats: lo's passes are skipped
        n = 1500
        return (rng.integers(I32.min, I32.max, n, endpoint=True).astype(
            np.int32), np.sort(rng.integers(-300, 300, n)).astype(np.int32))
    if case == "boundary_descent":
        # lo = iota but for one swap: lo's passes must run
        lo = np.arange(4097, dtype=np.int32)
        lo[[2048, 2049]] = lo[[2049, 2048]]
        return rng.integers(0, 40, 4097).astype(np.int32), lo
    if case == "constant_digit":
        # hi's byte 0 is the same in every pair
        n = 900
        hi = (rng.integers(-2**20, 2**20, n) & ~0xFF) | 0x5A
        return hi.astype(np.int32), rng.integers(0, 2**16, n).astype(
            np.int32)
    n = int(case.split("_")[1])
    words = rng.integers(I32.min, I32.max, (2, n), endpoint=True)
    return words[0].astype(np.int32), words[1].astype(np.int32)


PAIR_CASES = ["cells_iota", "negative_hi", "extremes", "repeated_lo",
              "sorted_lo", "boundary_descent", "constant_digit", "random_0",
              "random_1", "random_2", "random_255", "random_257",
              "random_4097"]


@pytest.mark.parametrize("case", PAIR_CASES)
def test_radix_sort2_matches_pallas_and_lexsort(case):
    hi, lo = _pairs(case)
    order = np.lexsort((lo, hi))
    want = (hi[order], lo[order])
    if hi.size >= 256 and hi.size & (hi.size - 1) == 0:
        pallas = bitonic_sort2_i32(jnp.asarray(hi), jnp.asarray(lo),
                                   interpret=True)
    else:
        pallas = sort2_padded_i32(jnp.asarray(hi), jnp.asarray(lo),
                                  interpret=True)
    th, tl = torch.from_numpy(hi), torch.from_numpy(lo)
    for got in (pallas, sort.radix_sort2_plain(th, tl), sort.sort2_i32(th, tl),
                sort.sort2_i32_plain(th, tl)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), w)


def test_radix_sort2_power_of_two_matches_bitonic2():
    """n a power of two: the JAX kernel itself, no padding."""
    rng = np.random.default_rng(7)
    hi = rng.integers(-40, 40, 512).astype(np.int32)
    lo = rng.integers(I32.min, I32.max, 512, endpoint=True).astype(np.int32)
    want = bitonic_sort2_i32(jnp.asarray(hi), jnp.asarray(lo),
                             interpret=True)
    got = sort.radix_sort2_plain(torch.from_numpy(hi), torch.from_numpy(lo))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("pairs", [False, True])
def test_capacity_rule(monkeypatch, pairs):
    """n = the limit goes to the radix sort, n = limit + 1 to the bitonic
    network: the rule the CUDA wrappers follow."""
    calls = []

    def radix(*args):
        calls.append("radix")
        return args[0] if len(args) == 1 else args

    def network(buf):
        calls.append("network")
        return buf

    monkeypatch.setattr(sort, "_network", network)
    limit = sort.RADIX_MAX_PAIRS if pairs else sort.RADIX_MAX_I32
    for n in (limit, limit + 1):
        x = torch.zeros(n, dtype=torch.int32)
        if pairs:
            monkeypatch.setattr(sort, "radix_sort2_plain", radix)
            sort.sort2_i32_plain(x, x)
        else:
            monkeypatch.setattr(sort, "radix_sort_plain", radix)
            sort.sort_i32_plain(x)
    assert calls == ["radix", "network"]
    assert (sort.RADIX_MAX_I32, sort.RADIX_MAX_PAIRS) == (427_904, 213_952)


@pytest.mark.parametrize("case,passes", [("int32", 3), ("int32_packed", 2),
                                         ("int32_packed_swap", 3),
                                         ("pairs", 4), ("pairs_iota", 2)])
def test_skipped_passes(monkeypatch, case, passes):
    """A digit where one bucket holds every key costs no pass: int32 keys
    with a constant byte 1 take 3 of 4 passes; pairs of cell < 300 and a
    shuffled index < 4097 take 4 of 8 (bytes 2-3 of both words are
    constant).  Keys in order in their low bits sort by the bits above
    only: packed (cell <= 257, index < 700) keys, whose low 10 bits are
    the index, take 2 passes (bits 10-17, 18-25), and 3 once two indices
    swap (bits 0-7, 8-15, 16-23); with the index in order (the stream
    iota), lo's passes go, and the pairs take 2."""
    ranked = []
    real = sort._bucket_ranks

    def counting(d):
        ranked.append(d.numel())
        return real(d)

    monkeypatch.setattr(sort, "_bucket_ranks", counting)
    if case.startswith("int32"):
        x = _keys("constant_digit" if case == "int32" else "packed")
        if case == "int32_packed":
            x[-1] = 257 * 1024 + 699          # cell bit 8 varies
        if case == "int32_packed_swap":
            x[[300, 301]] = x[[301, 300]]
        got = sort.radix_sort_plain(torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), np.sort(x))
    else:
        rng = np.random.default_rng(3)
        hi = rng.integers(0, 300, 4097).astype(np.int32)
        lo = np.arange(4097, dtype=np.int32)
        if case == "pairs":
            rng.shuffle(lo)
        got = sort.radix_sort2_plain(torch.from_numpy(hi),
                                     torch.from_numpy(lo))
        order = np.lexsort((lo, hi))
        for g, w in zip(got, (hi[order], lo[order])):
            np.testing.assert_array_equal(g.numpy(), w)
    assert len(ranked) == passes


def test_radix_word_orders_unsigned():
    """uint32(x) ^ 2^31 in [0, 2^32), increasing with x over the int32
    range: the order the radix passes compare."""
    x = torch.tensor([I32.min, I32.min + 1, -256, -1, 0, 1, 255, I32.max - 1,
                      I32.max], dtype=torch.int32)
    u = sort.radix_word(x)
    assert u.dtype == torch.int64
    assert int(u[0]) == 0 and int(u[-1]) == 2**32 - 1
    assert bool((u[1:] > u[:-1]).all())
