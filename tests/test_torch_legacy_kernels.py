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
