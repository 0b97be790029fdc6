"""The kernels' plain versions (the CPU path, and the oracle the CUDA kernels
are held against on the card) against the JAX Pallas kernels in interpret
mode: K1 sort, K3 cell counts, K2 capped scan read at each cell's last kept
row."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gndnet_tpu.ops.pallas_affine import (affine_scan_t, histogram_counts_pallas,
                                          histogram_ends as jax_histogram_ends)
from gndnet_tpu.ops.pallas_sort import sort_padded_i32
from gndnet_tpu_torch.ops import affine, sort


# --- K1 -------------------------------------------------------------------

@pytest.mark.parametrize("n", [300, 1000])
def test_sort_matches_pallas_sort(n):
    rng = np.random.default_rng(n)
    x = rng.integers(0, 2**31 - 2, n).astype(np.int32)
    want = np.asarray(sort_padded_i32(jnp.asarray(x), interpret=True))
    got = sort.sort_i32(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sort_packed_keys_and_duplicates():
    """Packed (cell, index) keys as the canvas builds them, and keys with
    many duplicates and both int32 extremes."""
    rng = np.random.default_rng(0)
    cells = rng.integers(0, 257, 700)
    packed = (cells * 1024 + np.arange(700)).astype(np.int32)
    dup = np.concatenate([rng.integers(-5, 5, 500),
                          np.full(60, np.iinfo(np.int32).max),
                          np.full(60, np.iinfo(np.int32).min)]).astype(np.int32)
    for x in (packed, dup, rng.permutation(dup)):
        got = sort.sort_i32(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, np.sort(x))


@pytest.mark.parametrize("n", [0, 1, 2, 3, 255, 256, 257])
def test_sort_any_length(n):
    x = np.random.default_rng(n).integers(-100, 100, n).astype(np.int32)
    got = sort.sort_i32(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), np.sort(x))


def test_sort_rejects_bad_input():
    with pytest.raises(ValueError):
        sort.sort_i32(torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        sort.sort_i32(torch.zeros((2, 2), dtype=torch.int32))


# --- K3 -------------------------------------------------------------------

@pytest.mark.parametrize("ny,nx", [(16, 16), (10, 13)])
def test_counts_match_pallas_histogram(ny, nx):
    rng = np.random.default_rng(ny * nx)
    ids = rng.integers(0, ny * nx + 1, (2, 1500)).astype(np.int32)
    ids[1, :400] = ny * nx                              # drop ids
    for x in (ids, np.sort(ids, axis=1)):               # unsorted, sorted
        want = np.asarray(histogram_counts_pallas(jnp.asarray(x), ny, nx,
                                                  interpret=True))
        got = affine.histogram_counts(torch.from_numpy(x), ny, nx)
        assert got.dtype == torch.int32 and got.shape == (2, ny, nx)
        np.testing.assert_array_equal(got.numpy(), want)


def test_ends_match_jax_histogram_ends():
    rng = np.random.default_rng(5)
    ids = np.sort(rng.integers(0, 13 * 10 + 1, (1, 900)), axis=1).astype(
        np.int32)
    want_ends, want_counts = jax_histogram_ends(jnp.asarray(ids), 10, 13,
                                                use_pallas=True,
                                                interpret=True)
    ends, counts = affine.histogram_ends(torch.from_numpy(ids), 10, 13)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    np.testing.assert_array_equal(ends.numpy(), np.asarray(want_ends))


def test_counts_all_drop_and_empty():
    ids = torch.full((1, 64), 16 * 16, dtype=torch.int32)
    assert int(affine.histogram_counts(ids, 16, 16).sum()) == 0
    empty = affine.histogram_counts(torch.zeros((1, 0), dtype=torch.int32),
                                    4, 4)
    assert empty.shape == (1, 4, 4) and int(empty.sum()) == 0


# --- K2 -------------------------------------------------------------------

def _stream(rng, ncells, n, a):
    """A cell-sorted stream with the drop id `ncells` at its tail, runs
    longer and shorter than the cap, and repeated points (exact ties)."""
    cell = np.sort(rng.integers(0, ncells + 1, n)).astype(np.int32)
    cell[-40:] = ncells
    cell[100:260] = cell[100]                           # one long run
    pts = (rng.normal(size=(n, a)) * 4).astype(np.float32)
    pts[300:340] = pts[300]                             # duplicates
    return cell, pts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cap", [7, None])
def test_scan_gather_matches_pallas_scan(dtype, cap):
    """chunk=128 forces the Pallas kernel to carry runs across grid steps;
    the port reads no chunks at all, so the per-cell results must agree at
    the rows the JAX caller gathers."""
    rng = np.random.default_rng(11)
    ncells, n, a, c = 40, 1024, 4, 16
    cell, pts = _stream(rng, ncells, n, a)
    valid = (cell < ncells).astype(np.float32)
    mmat = rng.normal(size=(a, c)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    tot_t, run_max = affine_scan_t(
        jnp.asarray(cell), jnp.asarray(pts.T), jnp.asarray(valid),
        jnp.asarray(mmat.T), max_points=cap, out_dtype=jdt, chunk=128,
        transpose_out=True, precision=jax.lax.Precision("highest"),
        interpret=True)
    tot_t = np.asarray(tot_t)
    run_max = np.asarray(run_max.astype(jnp.float32))

    counts = np.bincount(cell, minlength=ncells + 1)[:ncells].astype(np.int32)
    starts = (np.cumsum(counts) - counts).astype(np.int32)
    kept = counts if cap is None else np.minimum(counts, cap)
    rows = np.maximum(starts + kept - 1, 0)
    occ = counts > 0
    assert occ.sum() > 30 and counts.max() > 7

    tot, smax = affine.affine_scan_gather(
        torch.from_numpy(pts), torch.from_numpy(starts),
        torch.from_numpy(counts), torch.from_numpy(mmat), cap,
        getattr(torch, dtype))
    assert smax.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(tot.numpy()[occ, 3], tot_t[3, rows][occ])
    np.testing.assert_allclose(tot.numpy()[occ, :3], tot_t[:3, rows].T[occ],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(smax.float().numpy()[occ],
                                  run_max[rows][occ])
    assert (smax.float().numpy()[~occ] == np.float32(
        torch.tensor(affine.BIG_NEG).to(getattr(torch, dtype)).float())).all()
    assert (tot.numpy()[~occ] == 0).all()


def test_scan_gather_single_point_and_all_invalid():
    rng = np.random.default_rng(2)
    mmat = torch.from_numpy(rng.normal(size=(5, 8)).astype(np.float32))
    pts = torch.from_numpy(rng.normal(size=(1, 5)).astype(np.float32))
    counts = torch.tensor([0, 1, 0], dtype=torch.int32)
    starts = torch.tensor([0, 0, 1], dtype=torch.int32)
    tot, smax = affine.affine_scan_gather(pts, starts, counts, mmat, 4,
                                          torch.float32)
    assert tot[1].tolist() == pts[0, :3].tolist() + [1.0]
    want = pts[0, 0] * mmat[0]
    for k in range(1, 5):
        want = affine._fma(mmat[k], pts[0, k], want)
    assert torch.equal(smax[1], want)
    tot0, smax0 = affine.affine_scan_gather(
        pts, starts, torch.zeros_like(counts), mmat, 4, torch.bfloat16)
    assert int(tot0.abs().sum()) == 0
    assert bool((smax0.float() < -1e38).all())


def test_scan_rejects_bad_input():
    pts = torch.zeros((4, 9))
    s = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        affine.affine_scan_gather(pts, s, s, torch.zeros((9, 4)), 2,
                                  torch.float32)
    with pytest.raises(ValueError):
        affine.affine_scan_gather(torch.zeros((4, 4)), s, s,
                                  torch.zeros((4, 4)), 2, torch.float16)
