"""The training kernels' plain versions (the CPU path, and the oracle the
CUDA kernels are held against on the card) against the JAX Pallas kernels
in interpret mode: K4 (value, row) and K5 (packed key) argmax scans read at
each cell's last kept row and decoded as `_make_scan_gather` decodes them,
and K6 (d(mmat)) on the same table."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gndnet_tpu.ops.pallas_affine import affine_bwd_dmmat, affine_scan_t
from gndnet_tpu_torch.ops import affine

C3, C, A, N, CHUNK = 40, 16, 4, 1024, 128
HIGHEST = jax.lax.Precision("highest")


def _item_stream(rng, n):
    """One item's cell-sorted rows with its drop id C3 at the tail: runs
    longer than the cap, all-(-0.0) and all-(+0.0) points in either order
    (their activations tie at +0.0), distinct points whose activations
    collide only after bf16 rounding, and about 45% of rows duplicating an
    earlier row of their run."""
    cell = np.sort(rng.integers(0, C3 + 1, n)).astype(np.int32)
    cell[-30:] = C3
    cell[40:200] = cell[40]                               # one long run
    pts = (rng.normal(size=(n, A)) * 3).astype(np.float32)
    for r in range(1, n):
        if cell[r] == cell[r - 1] and rng.uniform() < 0.45:
            first = r - 1
            while first > 0 and cell[first - 1] == cell[r]:
                first -= 1
            pts[r] = pts[rng.integers(first, r)]
    # two cells of their own: [-0, +0] and [+0, -0] rows
    cell[:4] = [0, 0, 1, 1]
    cell[4:] = np.maximum(cell[4:], 2)
    pts[0] = pts[3] = -0.0
    pts[1] = pts[2] = 0.0
    # bf16 collisions: p and p * (1 + 2**-12) in one run
    r = 210
    assert cell[r] == cell[r + 1] and cell[r] < C3
    pts[r + 1] = pts[r] * np.float32(1 + 2**-12)
    return cell, pts


def _stream():
    """Two items on strided ids (stride C3 + 1): item 0 as above, item 1
    all invalid (every row on its drop id)."""
    rng = np.random.default_rng(21)
    cell0, pts0 = _item_stream(rng, 640)
    cell = np.concatenate([cell0, np.full(N - 640, 2 * C3 + 1, np.int32)])
    pts = np.concatenate([pts0, (rng.normal(size=(N - 640, A)) * 3)
                          .astype(np.float32)])
    mmat = rng.normal(size=(A, C)).astype(np.float32)
    mmat[:, 0] = np.abs(mmat[:, 0])                       # all > 0: -0, +0
    mmat[:, 1] = -np.abs(mmat[:, 1])
    sid = np.concatenate([np.arange(C3), C3 + 1 + np.arange(C3)])
    counts = np.array([(cell == s).sum() for s in sid], np.int32)
    starts = np.searchsorted(cell, sid).astype(np.int32)
    return cell, pts, mmat, starts, counts


def _jax_argmax(cell, pts, mmat, starts, counts, cap, dtype):
    """`_make_scan_gather.fwd` on the JAX side: (smax, argpos) per cell."""
    valid = (cell % (C3 + 1) != C3).astype(np.float32)
    packed = dtype == "bfloat16" and cap is not None
    outs = affine_scan_t(
        jnp.asarray(cell), jnp.asarray(pts.T), jnp.asarray(valid),
        jnp.asarray(mmat.T), max_points=cap, out_dtype=jnp.dtype(dtype),
        chunk=CHUNK, transpose_out=True, precision=HIGHEST,
        want_argmax=True, packed_argmax=packed, interpret=True)
    kept = counts if cap is None else np.minimum(counts, cap)
    ends = np.maximum(starts + kept - 1, 0)
    if packed:
        key = np.asarray(outs[1])[ends]
        mono = key >> 12
        bits = np.where(mono >= 32768, mono - 32768, 65535 - mono)
        smax = np.asarray(jnp.asarray(bits.astype(np.uint16)).view(
            jnp.bfloat16).astype(jnp.float32))
        argpos = starts[:, None] + (4095 - (key & 4095))
    else:
        smax = np.asarray(outs[1].astype(jnp.float32))[ends]
        argpos = np.asarray(outs[2])[ends]
    return smax, argpos


@pytest.mark.parametrize("dtype,cap", [("float32", 7), ("float32", None),
                                       ("bfloat16", None), ("bfloat16", 7)])
def test_argmax_scan_matches_pallas(dtype, cap):
    """K5 for bf16 with a cap, K4 otherwise: smax and argpos exact on
    occupied cells, chunk 128 forcing the Pallas kernel's carries."""
    cell, pts, mmat, starts, counts = _stream()
    want_smax, want_pos = _jax_argmax(cell, pts, mmat, starts, counts, cap,
                                      dtype)
    tdt = getattr(torch, dtype)
    packed = affine.packed_argmax(tdt, cap)
    assert packed == (dtype == "bfloat16" and cap is not None)
    wrapper = (affine.affine_scan_argmax_packed if packed
               else affine.affine_scan_argmax_pair)
    before = wrapper.launches
    tot, smax, argpos = wrapper(
        torch.from_numpy(pts), torch.from_numpy(starts),
        torch.from_numpy(counts), torch.from_numpy(mmat), cap, tdt)
    assert wrapper.launches == before          # the CPU runs the plain version
    assert smax.dtype == tdt and argpos.dtype == torch.int32
    occ = counts > 0
    assert occ[:C3].sum() > 25 and not occ[C3:].any()
    np.testing.assert_array_equal(smax.float().numpy()[occ], want_smax[occ])
    np.testing.assert_array_equal(argpos.numpy()[occ], want_pos[occ])
    assert (argpos.numpy()[~occ] == -1).all()
    # the serving scan gives the same values and sums
    tot2, smax2 = affine.affine_scan_gather(
        torch.from_numpy(pts), torch.from_numpy(starts),
        torch.from_numpy(counts), torch.from_numpy(mmat), cap, tdt)
    assert torch.equal(tot, tot2) and torch.equal(smax.float(), smax2.float())
    # each argmax row lies in its cell's kept window and attains the max
    kept = counts if cap is None else np.minimum(counts, cap)
    pos = argpos.numpy()
    assert ((pos >= starts[:, None]) & (pos < (starts + kept)[:, None]))[
        occ].all()


def test_tie_rules_differ_between_k4_and_k5():
    """An exact -0.0 / +0.0 pair of bf16 activations: K4 (value, row)
    keeps the first row of [-0.0, +0.0], K5 (mono16 key) takes the +0.0
    row; in [+0.0, -0.0] both keep the first.  The -0.0 comes from a
    product that underflows bf16 (2**-100 * -2**-40); the JAX package
    cannot make one on the CPU, where XLA's dot flushes such products and
    starts its sum at +0.0, so this pins the port's rule alone."""
    pts = np.zeros((4, A), np.float32)
    pts[[0, 3], 0] = -2.0**-40
    pts[[1, 2], 0] = 2.0**-40
    mmat = np.zeros((A, 2), np.float32)
    mmat[0, 0] = 2.0**-100
    mmat[:, 1] = 1.0
    args = (torch.from_numpy(pts), torch.tensor([0, 2], dtype=torch.int32),
            torch.tensor([2, 2], dtype=torch.int32), torch.from_numpy(mmat),
            7, torch.bfloat16)
    _, s4, p4 = affine.affine_scan_argmax_pair(*args)
    _, s5, p5 = affine.affine_scan_argmax_packed(*args)
    assert (s4[:, 0] == 0).all() and (s5[:, 0] == 0).all()
    assert p4[:, 0].tolist() == [0, 2] and p5[:, 0].tolist() == [1, 2]
    assert not torch.signbit(s5[0, 0]) and torch.signbit(s4[0, 0])
    assert p4[:, 1].tolist() == p5[:, 1].tolist() == [1, 2]


@pytest.mark.parametrize("dtype,cap", [("float32", 7), ("bfloat16", 7),
                                       ("bfloat16", None)])
def test_dmmat_matches_pallas(dtype, cap):
    """K6 against `affine_bwd_dmmat` on `_make_scan_gather.bwd`'s table
    (strided ids, a zero drop row per item), within 1e-5 of the result's
    scale: only the order of the f32 sum differs."""
    cell, pts, mmat, starts, counts = _stream()
    _, argpos = _jax_argmax(cell, pts, mmat, starts, counts, cap, dtype)
    rng = np.random.default_rng(5)
    d_smax = np.array(jnp.asarray(rng.normal(size=(2 * C3, C)).astype(
        np.float32)).astype(jnp.dtype(dtype)).astype(jnp.float32))
    table = np.concatenate([argpos.astype(np.float32), d_smax], axis=1)
    table = np.pad(table.reshape(2, C3, 2 * C), ((0, 0), (0, 1), (0, 0)))
    both = table.reshape(-1, 2 * C)[cell]
    want = np.asarray(affine_bwd_dmmat(
        jnp.asarray(cell), jnp.asarray(both), jnp.asarray(pts.T), C,
        out_dtype=jnp.dtype(dtype), chunk=CHUNK, precision=HIGHEST,
        interpret=True))                                   # (C, A)
    pos = np.where(counts[:, None] > 0, argpos, -1).astype(np.int32)
    got = affine.affine_bwd_dmmat(
        torch.from_numpy(pts), torch.from_numpy(pos),
        torch.from_numpy(d_smax).to(getattr(torch, dtype)),
        torch.from_numpy(counts), getattr(torch, dtype))
    assert got.shape == (A, C) and got.dtype == torch.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy().T, want, rtol=0, atol=1e-5 * scale)


def test_dmmat_skips_empty_cells():
    pts = torch.ones((3, 4))
    argpos = torch.tensor([[0, 1], [2, -1], [1, 1]], dtype=torch.int32)
    d = torch.ones((3, 2))
    counts = torch.tensor([1, 1, 0], dtype=torch.int32)
    got = affine.affine_bwd_dmmat(pts, argpos, d, counts, torch.float32)
    assert got[:, 0].tolist() == [2.0] * 4 and got[:, 1].tolist() == [1.0] * 4


def test_training_kernels_reject_bad_input():
    pts = torch.zeros((4, 4))
    s = torch.zeros(2, dtype=torch.int32)
    m = torch.zeros((4, 8))
    with pytest.raises(ValueError):                       # K5 needs bf16
        affine.affine_scan_argmax_packed(pts, s, s, m, 7, torch.float32)
    with pytest.raises(ValueError):                       # ... and a cap
        affine.affine_scan_argmax_packed(pts, s, s, m, None, torch.bfloat16)
    with pytest.raises(ValueError):
        affine.affine_scan_argmax_packed(pts, s, s, m, 5000, torch.bfloat16)
    with pytest.raises(ValueError):
        affine.affine_bwd_dmmat(pts, torch.zeros((2, 8)), torch.zeros((2, 8)),
                                s, torch.float32)


def test_packed_argmax_rank_field_edge_matches_pallas():
    """K5 at cap 4096, the edge of the key's 12-bit rank field: one run of
    4 200 points whose unique maximum of channel 0 sits at rank 4095, the
    last kept row, with larger rows beyond the cap, and ties of channel 1
    at ranks 4000 and 4090; beside it short runs and the drop id.  smax
    and argpos equal `affine_scan_t(..., packed_argmax=True)` in
    interpret mode, decoded as `_make_scan_gather` decodes it."""
    rng = np.random.default_rng(4096)
    cap, ncells, n = affine.PACKED_MAX_CAP, 6, 4608
    cell = np.concatenate([np.zeros(4200), np.sort(rng.integers(
        1, ncells + 1, n - 4200))]).astype(np.int32)
    cell[-8:] = ncells                                    # drop rows
    pts = (rng.normal(size=(n, A)) * 3).astype(np.float32)
    pts[:, 0] = np.abs(pts[:, 0])
    pts[4095] = [40.0, 0.5, 0.5, 0.5]
    pts[4096:4200] = [80.0, 0.5, 0.5, 0.5]                # beyond the cap
    pts[4090] = pts[4000] = [0.25, 50.0, 0.0, 0.0]
    mmat = np.zeros((A, C), np.float32)
    mmat[0, 0] = 1.0                                      # channel 0: x
    mmat[1, 1] = 1.0                                      # channel 1: y
    mmat[:, 2:] = rng.normal(size=(A, C - 2))
    valid = (cell < ncells).astype(np.float32)
    outs = affine_scan_t(
        jnp.asarray(cell), jnp.asarray(pts.T), jnp.asarray(valid),
        jnp.asarray(mmat.T), max_points=cap, out_dtype=jnp.bfloat16,
        chunk=512, transpose_out=True, precision=HIGHEST, want_argmax=True,
        packed_argmax=True, interpret=True)
    counts = np.bincount(cell, minlength=ncells + 1)[:ncells].astype(
        np.int32)
    starts = (np.cumsum(counts) - counts).astype(np.int32)
    key = np.asarray(outs[1])[np.maximum(starts + np.minimum(counts, cap)
                                         - 1, 0)]
    bits = np.where(key >> 12 >= 32768, (key >> 12) - 32768,
                    65535 - (key >> 12))
    want_smax = np.asarray(jnp.asarray(bits.astype(np.uint16)).view(
        jnp.bfloat16).astype(jnp.float32))
    want_pos = starts[:, None] + (4095 - (key & 4095))
    tot, smax, argpos = affine.affine_scan_argmax_packed(
        torch.from_numpy(pts), torch.from_numpy(starts),
        torch.from_numpy(counts), torch.from_numpy(mmat), cap,
        torch.bfloat16)
    occ = counts > 0
    assert counts[0] == 4200 and occ.all()
    np.testing.assert_array_equal(smax.float().numpy(), want_smax)
    np.testing.assert_array_equal(argpos.numpy(), want_pos)
    assert argpos[0, 0] == 4095 and smax[0, 0] == 40.0
    assert argpos[0, 1] == 4000 and tot[0, 3] == cap
