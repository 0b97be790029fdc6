"""K8 (`affine_segment_scan`) and K9 (`segment_broadcast_t`) of the port
against the JAX package's Pallas kernels in interpret mode, at the shapes
of tests/test_pillarize.py (1024 rows over 40 cells with chunk=128, so the
JAX kernel carries across many chunks).

K8's product: XLA's CPU dot (what interpret mode runs) accumulates the 8
terms in an order that depends on the output width.  At 64 channels (the
model's width and the profile's) it is the in-order fused multiply-add
chain the port uses, so the maxima are exact; at 16 (the JAX test's
width) it keeps four partial sums (terms k and k + 4 each), so a product
may differ in its last bit: there the maxima are held to one unit in the
last place of the output type, of the largest |activation|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gndnet_tpu.ops.pallas_affine import affine_segment_scan as jax_scan
from gndnet_tpu.ops.pallas_affine import segment_broadcast_t as jax_bcast
from gndnet_tpu_torch.ops import affine_aux

EXACT_WIDTH = 64


def _k8_inputs(seed, width, long_run=False):
    """tests/test_pillarize.py's stream: 1024 rows in 40 sorted cells, the
    kept mask rank < 7 in column 3, a uniform extra feature in column 4,
    mmat8 row 3 zero; `long_run` puts 600 rows in one cell, across the
    port's tiles."""
    rng = np.random.default_rng(seed)
    ncells, n, cap = 40, 1024, 7
    cell = np.sort(rng.integers(0, ncells, n)).astype(np.int32)
    if long_run:
        cell[200:800] = cell[200]
        cell = np.sort(cell)
    pts8 = np.zeros((n, 8), np.float32)
    pts8[:, :3] = rng.normal(size=(n, 3))
    start = np.searchsorted(cell, cell, side="left")
    rank = np.arange(n) - start
    pts8[:, 3] = (rank < cap).astype(np.float32)
    pts8[:, 4] = rng.uniform(size=n)
    mmat8 = np.zeros((8, width), np.float32)
    for r in (0, 1, 2, 4):
        mmat8[r] = rng.normal(size=width) * 0.3
    return cell, pts8, mmat8, rank


@pytest.mark.parametrize("long_run", [False, True])
@pytest.mark.parametrize("width", [16, EXACT_WIDTH])
@pytest.mark.parametrize("max_prefix", [None, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_affine_segment_scan_matches_pallas(dtype, max_prefix, width,
                                            long_run):
    """Maxima and counts exact, sums within 1e-5 of their scale (another
    f32 summation order); with `max_prefix` only the rows the JAX contract
    defines (rank < max_prefix) are compared, the port's others being
    complete prefixes."""
    cell, pts8, mmat8, rank = _k8_inputs(width + int(long_run), width,
                                         long_run)
    want_tot, want_max = jax_scan(
        jnp.asarray(cell), jnp.asarray(pts8), jnp.asarray(mmat8),
        out_dtype=jnp.dtype(dtype), chunk=128, max_prefix=max_prefix,
        interpret=True)
    got_tot, got_max = affine_aux.affine_segment_scan(
        torch.from_numpy(cell), torch.from_numpy(pts8),
        torch.from_numpy(mmat8), out_dtype=getattr(torch, dtype), chunk=128,
        max_prefix=max_prefix)
    assert got_tot.dtype == torch.float32
    assert got_max.dtype == getattr(torch, dtype)
    rows = np.ones(len(cell), bool) if max_prefix is None \
        else rank < max_prefix
    want_tot = np.asarray(want_tot)[rows]
    want_max = np.asarray(want_max.astype(jnp.float32))[rows]
    got_tot, got_max = got_tot.numpy()[rows], got_max.float().numpy()[rows]
    if width == EXACT_WIDTH:
        np.testing.assert_array_equal(got_max, want_max)
    else:
        live = want_max > -1e38
        np.testing.assert_array_equal(got_max[~live], want_max[~live])
        ulp = 2.0 ** (-23 if dtype == "float32" else -7)
        np.testing.assert_allclose(got_max[live], want_max[live], rtol=0,
                                   atol=ulp * np.abs(want_max[live]).max())
    np.testing.assert_array_equal(got_tot[:, 3], want_tot[:, 3])
    scale = np.abs(want_tot[:, :3]).max()
    np.testing.assert_allclose(got_tot[:, :3], want_tot[:, :3], rtol=0,
                               atol=1e-5 * scale)


def test_affine_segment_scan_is_a_complete_prefix():
    """Every row holds its run's inclusive prefix: the sums against a
    sequential numpy prefix, the maxima exactly against a running max."""
    cell, pts8, mmat8, _ = _k8_inputs(3, 64, long_run=True)
    tot, amax = affine_aux.affine_segment_scan(
        torch.from_numpy(cell), torch.from_numpy(pts8),
        torch.from_numpy(mmat8), chunk=128)
    act = np.where(pts8[:, 3:4] > 0,
                   affine_aux.affine._activations(
                       torch.from_numpy(pts8), torch.from_numpy(mmat8),
                       torch.float32).numpy(), -3.0e38)
    g = pts8[:, :4] * pts8[:, 3:4]
    run_tot, run_max = np.zeros(4), None
    for i in range(len(cell)):
        if i == 0 or cell[i] != cell[i - 1]:
            run_tot, run_max = np.zeros(4), act[i]
        run_tot = run_tot + g[i]
        run_max = np.maximum(run_max, act[i])
        np.testing.assert_allclose(tot[i].numpy(), run_tot, rtol=0,
                                   atol=1e-4)
        np.testing.assert_array_equal(amax[i].numpy(), run_max)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_affine_segment_scan_long_run_matches_pallas(dtype):
    """A 4 096-row stream that is one run for 3 000 rows: 12 of the port's
    256-row tiles carry it (the kernel's look-back chain) and 24 of the
    JAX kernel's 128-row chunks; maxima and counts exact at width 64, sums
    within 1e-5 of their scale (another f32 summation order)."""
    rng = np.random.default_rng(11)
    n, width = 4096, EXACT_WIDTH
    cell = np.sort(rng.integers(0, 80, n)).astype(np.int32)
    cell[600:3600] = cell[600]
    cell = np.sort(cell)
    assert np.bincount(cell).max() >= 3000
    pts8 = np.zeros((n, 8), np.float32)
    pts8[:, :3] = rng.normal(size=(n, 3)) * 5
    pts8[:, 3] = rng.random(n) < 0.9
    pts8[:, 4] = rng.uniform(size=n)
    mmat8 = (rng.normal(size=(8, width)) * 0.3).astype(np.float32)
    mmat8[3] = 0
    want_tot, want_max = jax_scan(
        jnp.asarray(cell), jnp.asarray(pts8), jnp.asarray(mmat8),
        out_dtype=jnp.dtype(dtype), chunk=128, interpret=True)
    got_tot, got_max = affine_aux.affine_segment_scan(
        torch.from_numpy(cell), torch.from_numpy(pts8),
        torch.from_numpy(mmat8), out_dtype=getattr(torch, dtype), chunk=128)
    np.testing.assert_array_equal(got_max.float().numpy(),
                                  np.asarray(want_max.astype(jnp.float32)))
    want_tot = np.asarray(want_tot)
    np.testing.assert_array_equal(got_tot[:, 3].numpy(), want_tot[:, 3])
    scale = np.abs(want_tot[:, :3]).max()
    np.testing.assert_allclose(got_tot[:, :3].numpy(), want_tot[:, :3],
                               rtol=0, atol=1e-5 * scale)


LAYOUT_ROWS = [1, 2, 255, 256, 257, 1023, 1024, 1025, 102_400, 1_605_632]


@pytest.mark.parametrize("channels", [1, 6, 68, 128, 2048])
def test_k8_layout(channels):
    """K8's launch geometry: the tiles and slices of `segment.scan_layout`
    (the order the plain version repeats), the 4 x S sum items on one warp
    and the (segment, 4-channel) items on the block's other 7 warps, every
    row and channel covered, shared memory within the 227 KB a block may
    have; 2048 channels are refused (4 + C scan columns at most 2048)."""
    width = 4 + channels
    if width > 2048:
        n = 256
        args = (torch.zeros(n, dtype=torch.int32), torch.zeros((n, 8)),
                torch.zeros((8, channels)))
        with pytest.raises(ValueError, match="channels"):
            affine_aux.affine_segment_scan(*args, chunk=1)
        return
    for n in LAYOUT_ROWS:
        tile, per, chunks, tiles, smem = affine_aux.k8_layout(n, width)
        assert (tile, per) == affine_aux.segment.scan_layout(width)[::2]
        slices = -(-tile // per)
        assert slices * per >= tile and 4 * slices <= 256
        assert chunks * affine_aux.K8_CHANNELS >= channels
        assert (chunks - 1) * affine_aux.K8_CHANNELS < channels
        assert tiles * tile >= n and (tiles - 1) * tile < n
        quads = -(-min(channels, affine_aux.K8_CHANNELS) // 4)
        segments = 224 // quads
        assert quads * segments <= 224
        assert segments * -(-tile // segments) >= tile
        assert smem <= 227 * 1024
        assert chunks * tiles < 2**31


@pytest.mark.parametrize("channels", [1, 6, 68, 128, 2048])
def test_k9_layout(channels):
    """K9's launch geometry: tiles of whole 128-row warp steps covering
    every row, channel groups of one warp each covering every channel, a
    grid the card can launch."""
    for n in LAYOUT_ROWS:
        rows, group, groups, tiles = affine_aux.k9_layout(n, channels)
        assert rows % 128 == 0 and group * 32 <= 1024
        assert tiles * rows >= n and (tiles - 1) * rows < n
        assert groups * group >= channels
        assert (groups - 1) * group < channels
        assert groups * tiles < 2**31


def test_k8_k9_sync_state(monkeypatch):
    """The ticket and flags K8 and K9 share on a device: made zeroed, grown
    when a call needs more flags, and each call a new epoch; made anew,
    zeroed, when the epochs run out (a flag holds epoch << 2 | status in
    32 bits)."""
    monkeypatch.setattr(affine_aux, "_sync_state", {})
    sync, epoch = affine_aux._sync("cpu", 10)
    assert sync.dtype == torch.int32 and sync.numel() >= 11
    assert not sync.any() and epoch == 1
    again, epoch2 = affine_aux._sync("cpu", 4)
    assert again is sync and epoch2 == 2
    grown, epoch3 = affine_aux._sync("cpu", 100)
    assert grown.numel() >= 101 and not grown.any() and epoch3 >= 1
    monkeypatch.setattr(affine_aux, "_EPOCHS", epoch3 + 2)
    affine_aux._sync("cpu", 4)
    fresh, epoch5 = affine_aux._sync("cpu", 4)
    assert epoch5 == 1 and fresh is not grown and not fresh.any()


def _k9_inputs(seed, payload_only):
    """tests/test_pillarize.py's broadcast stream: 9 runs of 1-300 rows
    padded to a multiple of 128 with id 99, 6 channels; the payload at run
    starts and -3e38 elsewhere, or random values everywhere."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 300, 9)
    cell = np.sort(np.concatenate(
        [np.full(s, c, np.int32) for c, s in enumerate(sizes)]))
    n = -(-cell.size // 128) * 128
    cell = np.concatenate([cell, np.full(n - cell.size, 99, np.int32)])
    starts = np.flatnonzero(np.diff(cell, prepend=-1))
    if payload_only:
        vals = np.full((n, 6), -3.0e38, np.float32)
        vals[starts] = rng.normal(size=(starts.size, 6)).astype(np.float32)
    else:
        vals = rng.normal(size=(n, 6)).astype(np.float32)
    return cell, np.ascontiguousarray(vals.T)


@pytest.mark.parametrize("payload_only", [True, False])
def test_segment_broadcast_t_matches_pallas(payload_only):
    cell, vals_t = _k9_inputs(5, payload_only)
    want = np.asarray(jax_bcast(jnp.asarray(cell), jnp.asarray(vals_t),
                                chunk=128, interpret=True))
    got = affine_aux.segment_broadcast_t(torch.from_numpy(cell),
                                         torch.from_numpy(vals_t), chunk=128)
    assert got.shape == vals_t.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_legacy_kernels_keep_the_jax_checks():
    cell, pts8, mmat8, _ = _k8_inputs(0, 16)
    args = (torch.from_numpy(cell), torch.from_numpy(pts8),
            torch.from_numpy(mmat8))
    with pytest.raises(ValueError, match="divisible"):
        affine_aux.affine_segment_scan(*args, chunk=1000)
    with pytest.raises(ValueError, match="out_dtype"):
        affine_aux.affine_segment_scan(*args, out_dtype=torch.float16)
    with pytest.raises(ValueError, match=r"\(N, 8\)"):
        affine_aux.affine_segment_scan(args[0], args[1][:, :4], args[2])
    cell, vals_t = _k9_inputs(0, True)
    with pytest.raises(ValueError, match="divisible"):
        affine_aux.segment_broadcast_t(torch.from_numpy(cell),
                                       torch.from_numpy(vals_t), chunk=1000)


def test_trace_prefix_marks_every_phase():
    """The K8 phase trace (`python -m gndnet_tpu_torch.trace_prefix`) finds
    each place it stamps in csrc/prefix_segment.cu, so an edit of the
    kernel that moves one fails here and not on the card."""
    from gndnet_tpu_torch import trace_prefix
    src = trace_prefix.instrumented_source()
    for k in range(7):
        assert src.count(f"STAMP({k})") == 1
    assert 'extern "C" int set_trace' in src
