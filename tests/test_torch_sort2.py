"""K10: the port's lexicographic (hi, lo) pair sort (`sort2_i32`, on the CPU
its plain version, the kernel's network in PyTorch) against the JAX
package's `bitonic_sort2_i32` / `sort2_padded_i32` in interpret mode and
against `np.lexsort`.  Exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gndnet_tpu.ops.pallas_sort import bitonic_sort2_i32, sort2_padded_i32
from gndnet_tpu_torch.ops import sort

I32 = np.iinfo(np.int32)


def _port(hi, lo):
    h, l_ = sort.sort2_i32(torch.from_numpy(hi), torch.from_numpy(lo))
    assert h.dtype == l_.dtype == torch.int32
    return h.numpy(), l_.numpy()


def _lexsorted(hi, lo):
    order = np.lexsort((lo, hi))
    return hi[order], lo[order]


@pytest.mark.parametrize("n", [256, 1024])
@pytest.mark.parametrize("static", [True, False])
def test_sort2_matches_pallas(n, static):
    """Duplicate-heavy hi with a shuffled unique lo, the call site's key
    structure, against both schedules of the Pallas kernel."""
    rng = np.random.default_rng(n)
    hi = rng.integers(0, 63, n).astype(np.int32)
    lo = np.arange(n, dtype=np.int32)
    rng.shuffle(lo)
    want = bitonic_sort2_i32(jnp.asarray(hi), jnp.asarray(lo),
                             static=static, interpret=True)
    got = _port(hi, lo)
    for g, w, ref in zip(got, want, _lexsorted(hi, lo)):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(g, ref)


def test_sort2_padded_non_pow2_at_the_call_site():
    """hi = cell id in [0, 62 501] (fine_grid's cells and drop id), lo =
    the stream iota, n = 3000 padded to 4096: the port, the JAX padded
    entry point and the (cell, iota) lexsort it replaces agree, and the
    result is the stable sort by cell."""
    rng = np.random.default_rng(3)
    n = 3000
    hi = rng.integers(0, 62_502, n).astype(np.int32)
    lo = np.arange(n, dtype=np.int32)
    want = sort2_padded_i32(jnp.asarray(hi), jnp.asarray(lo), static=False,
                            interpret=True)
    got = _port(hi, lo)
    for g, w, ref in zip(got, want, _lexsorted(hi, lo)):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(g, ref)
    np.testing.assert_array_equal(got[1], np.argsort(hi, kind="stable"))


@pytest.mark.parametrize("n", [1, 2, 255, 1000])
def test_sort2_extremes_and_repeated_lo(n):
    """hi holding INT32_MAX (the pad pair's word) and INT32_MIN among real
    keys, lo over the full range with repeats, n not a power of two."""
    rng = np.random.default_rng(n)
    hi = rng.integers(I32.min, I32.max, n, endpoint=True).astype(np.int32)
    hi[::3] = I32.max
    hi[1::5] = I32.min
    lo = rng.integers(I32.min, I32.max, n, endpoint=True).astype(np.int32)
    lo[::4] = I32.max
    lo[2::7] = lo[0]
    for g, ref in zip(_port(hi, lo), _lexsorted(hi, lo)):
        np.testing.assert_array_equal(g, ref)
    hi[:] = I32.max
    lo[:] = I32.max                          # every pair equals the pad
    for g, ref in zip(_port(hi, lo), _lexsorted(hi, lo)):
        np.testing.assert_array_equal(g, ref)


def test_pack_pairs_orders_lexicographically():
    """The kernel's int64 key: hi * 2^32 + lo + 2^31 is monotone in
    (hi, lo) and unpacks to the pair."""
    hi = torch.tensor([I32.min, I32.min, -1, -1, 0, 0, I32.max, I32.max],
                      dtype=torch.int32)
    lo = torch.tensor([I32.min, I32.max, I32.max, I32.min + 1, -1, 0,
                       I32.min, I32.max], dtype=torch.int32)
    key = sort.pack_pairs(hi, lo)
    assert key.dtype == torch.int64
    assert int(key[0]) == -2**63 and int(key[-1]) == 2**63 - 1
    order = torch.argsort(key)
    want = np.lexsort((lo.numpy(), hi.numpy()))
    np.testing.assert_array_equal(order.numpy(), want)
    h, l_ = sort.unpack_pairs(key)
    assert torch.equal(h, hi) and torch.equal(l_, lo)


def test_sort2_checks_its_inputs():
    x = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="differ"):
        sort.sort2_i32(x, x[:4])
    with pytest.raises(ValueError, match="int32"):
        sort.sort2_i32(x.long(), x)
    h, l_ = sort.sort2_i32(x[:0], x[:0])
    assert h.numel() == l_.numel() == 0
