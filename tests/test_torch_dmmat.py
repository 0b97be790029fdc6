"""The plain versions of K6 (d(mmat)) and K4 (the (value, row) argmax scan)
against the JAX Pallas kernels in interpret mode, at the shapes the card's
kernels must handle besides kitti_sem's: 1, 3 and 8 features, 24, 100 and
129 channels (fewer than a warp's 64, two channel groups, an odd count),
an item whose cells are all empty, channels that share one argmax row,
ties and signed-zero maxima, and a run longer than K5's 4096-row key."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gndnet_tpu.ops.pallas_affine import affine_bwd_dmmat, affine_scan_t
from gndnet_tpu_torch.ops import affine

HIGHEST = __import__("jax").lax.Precision("highest")
C3, CHUNK = 24, 128          # cells per item, Pallas chunk


def _two_items(rng, n, a, item0):
    """Strided ids (stride C3 + 1) of two items: item 0's `item0` rows on
    sorted random cells with its drop id at the tail and six one-point
    cells, item 1's rows all on its drop id (every cell empty).  Returns
    cell (n,), pts (n, a), starts and counts (2 * C3,)."""
    cell0 = np.sort(rng.integers(6, C3 + 1, item0 - 6))
    cell0 = np.concatenate([np.arange(6), cell0]).astype(np.int32)
    cell0[-10:] = C3
    cell = np.concatenate([cell0, np.full(n - item0, 2 * C3 + 1, np.int32)])
    pts = (rng.normal(size=(n, a)) * 3).astype(np.float32)
    sid = np.concatenate([np.arange(C3), C3 + 1 + np.arange(C3)])
    counts = np.array([(cell == s).sum() for s in sid], np.int32)
    starts = np.searchsorted(cell, sid).astype(np.int32)
    return cell, pts, starts, counts


@pytest.mark.parametrize("width", [24, 100, 129])
@pytest.mark.parametrize("a", [1, 3, 8])
def test_dmmat_matches_pallas_widths(a, width):
    """K6's plain version against `affine_bwd_dmmat` in interpret mode,
    within 1e-5 of the result's scale (only the f32 summation order
    differs): argmax rows drawn anywhere in each cell's run, channels 0-2
    sharing one row, one-point cells whose channels all share theirs, and
    a second item with no occupied cell.  bf16 at 100 channels, f32 at
    the others."""
    dtype = "bfloat16" if width == 100 else "float32"
    rng = np.random.default_rng(100 * a + width)
    n = 512
    cell, pts, starts, counts = _two_items(rng, n, a, 384)
    occ = counts > 0
    assert occ[:6].all() and (counts[:6] == 1).all() and not occ[C3:].any()
    pos = np.full((2 * C3, width), -1, np.int32)
    for c in np.flatnonzero(occ):
        pos[c] = starts[c] + rng.integers(0, counts[c], width)
        pos[c, :3] = pos[c, 0]
    d_smax = np.array(jnp.asarray(rng.normal(size=(2 * C3, width)).astype(
        np.float32)).astype(jnp.dtype(dtype)).astype(jnp.float32))
    table = np.concatenate([pos.astype(np.float32), d_smax], axis=1)
    table = np.pad(table.reshape(2, C3, 2 * width), ((0, 0), (0, 1), (0, 0)))
    both = table.reshape(-1, 2 * width)[cell]
    want = np.asarray(affine_bwd_dmmat(
        jnp.asarray(cell), jnp.asarray(both), jnp.asarray(pts.T), width,
        out_dtype=jnp.dtype(dtype), chunk=CHUNK, precision=HIGHEST,
        interpret=True))                                   # (C, A)
    tdt = getattr(torch, dtype)
    before = affine.affine_bwd_dmmat.launches
    got = affine.affine_bwd_dmmat(
        torch.from_numpy(pts), torch.from_numpy(pos),
        torch.from_numpy(d_smax).to(tdt), torch.from_numpy(counts), tdt)
    assert affine.affine_bwd_dmmat.launches == before     # the plain version
    assert got.shape == (a, width) and got.dtype == torch.float32
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got.numpy().T, want, rtol=0, atol=1e-5 * scale)


def _jax_pair(cell, pts, mmat, starts, counts, cap, dtype):
    """`affine_scan_t(want_argmax=True)` (the (value, row) mode) in
    interpret mode, read at each cell's last kept row: (smax, argpos)."""
    valid = (cell % (C3 + 1) != C3).astype(np.float32)
    outs = affine_scan_t(
        jnp.asarray(cell), jnp.asarray(pts.T), jnp.asarray(valid),
        jnp.asarray(mmat.T), max_points=cap, out_dtype=jnp.dtype(dtype),
        chunk=CHUNK if cell.shape[0] < 4096 else 512, transpose_out=True,
        precision=HIGHEST, want_argmax=True, packed_argmax=False,
        interpret=True)
    kept = counts if cap is None else np.minimum(counts, cap)
    ends = np.maximum(starts + kept - 1, 0)
    return (np.asarray(outs[1].astype(jnp.float32))[ends],
            np.asarray(outs[2])[ends])


def _check_pair(cell, pts, mmat, starts, counts, cap, dtype):
    want_smax, want_pos = _jax_pair(cell, pts, mmat, starts, counts, cap,
                                    dtype)
    tdt = getattr(torch, dtype)
    assert not affine.packed_argmax(tdt, cap)
    tot, smax, argpos = affine.affine_scan_argmax_pair(
        torch.from_numpy(pts), torch.from_numpy(starts),
        torch.from_numpy(counts), torch.from_numpy(mmat), cap, tdt)
    occ = counts > 0
    np.testing.assert_array_equal(smax.float().numpy()[occ], want_smax[occ])
    np.testing.assert_array_equal(argpos.numpy()[occ], want_pos[occ])
    assert (argpos.numpy()[~occ] == -1).all()
    return smax.float().numpy(), argpos.numpy()


def test_pair_argmax_ties_and_signed_zeros_matches_pallas():
    """K4 at f32 against Pallas: cells whose rows are duplicates of one
    point (every channel ties, so every channel keeps the run's first
    row), and cells whose maximum is zero, reached by -0.0 and +0.0
    points (their activations are +0.0) after negative ones, in either
    order: the first zero row wins."""
    rng = np.random.default_rng(8)
    a, width, n = 4, 24, 512
    cell, pts, starts, counts = _two_items(rng, n, a, 384)
    mmat = rng.normal(size=(a, width)).astype(np.float32)
    mmat[:, 0] = np.abs(mmat[:, 0])                  # channel 0: all > 0
    dup = [c for c in range(6, C3) if counts[c] >= 4][:4]
    zero = [c for c in range(6, C3) if counts[c] >= 4][4:8]
    assert len(dup) == 4 and len(zero) == 4
    for c in dup:
        pts[starts[c]:starts[c] + counts[c]] = pts[starts[c]]
    for i, c in enumerate(zero):
        s = starts[c]
        pts[s:s + counts[c]] = -np.abs(pts[s:s + counts[c]]) - 0.5
        pts[s + 1 + i % 2] = -0.0
        pts[s + 2 - i % 2] = 0.0
    smax, argpos = _check_pair(cell, pts, mmat, starts, counts, None,
                               "float32")
    for c in dup:
        assert (argpos[c] == starts[c]).all()
    for c in zero:
        assert smax[c, 0] == 0.0 and argpos[c, 0] == starts[c] + 1


def test_pair_argmax_bf16_nocap_long_run_matches_pallas():
    """K4 at bf16 with no cap (the mode `_make_scan_gather` takes for bf16
    without a cap) on a run of 4 200 rows, past K5's 12-bit rank field,
    whose channel-0 maximum sits at row 4 150 and whose channel-1 maximum
    ties at rows 4 100 and 4 180, beside short runs and the drop id."""
    rng = np.random.default_rng(4200)
    a, width, n = 4, 24, 4608
    cell = np.concatenate([np.zeros(4200), np.sort(rng.integers(
        1, C3 + 1, n - 4200))]).astype(np.int32)
    cell[-8:] = C3
    pts = (rng.normal(size=(n, a)) * 3).astype(np.float32)
    pts[:, :2] = -np.abs(pts[:, :2])
    pts[4150, 0] = 40.0
    pts[4100, 1] = pts[4180, 1] = 50.0
    mmat = np.zeros((a, width), np.float32)
    mmat[0, 0] = 1.0
    mmat[1, 1] = 1.0
    mmat[:, 2:] = rng.normal(size=(a, width - 2))
    counts = np.bincount(cell, minlength=C3 + 1)[:C3].astype(np.int32)
    starts = (np.cumsum(counts) - counts).astype(np.int32)
    smax, argpos = _check_pair(cell, pts, mmat, starts, counts, None,
                               "bfloat16")
    assert counts[0] == 4200
    assert argpos[0, 0] == 4150 and smax[0, 0] == 40.0
    assert argpos[0, 1] == 4100 and smax[0, 1] == 50.0
