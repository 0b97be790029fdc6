"""K7 of the port (`ops/segment.py`: the suffix segmented reduce and
`segment_reduce_canvas`) against the JAX package's Pallas kernel in
interpret mode, chunk 128, N <= 2048.  Max is exact; sums differ from the
TPU kernel's tree order only by rounding: within 1e-5 of the largest
|sum|, and the count column (sums of 1.0) exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gndnet_tpu.ops import pallas_segment as jseg
from gndnet_tpu_torch.ops import segment

CHUNK = 128
SUM_ATOL = 1e-5    # share of the largest |sum|


def _cells(kind, rng, n=1024):
    """Non-decreasing int32 id streams of the shapes the frontends give."""
    if kind == "runs_across_chunks":
        cells = np.sort(rng.integers(0, 40, n))
        cells[300:620] = cells[300]                # one run over 3 chunks
        return np.sort(cells)
    if kind == "negated_flipped":                  # the prefix-sum stream
        return np.flip(-np.sort(rng.integers(0, 60, n)))
    if kind == "single_cell":
        return np.full(n, 7)
    if kind == "drop_tail":                        # shared drop id at B=2
        cells = np.sort(rng.integers(0, 2 * 256, n))
        cells[n - 700:] = 2 * 256
        return cells
    raise ValueError(kind)


KINDS = ["runs_across_chunks", "negated_flipped", "single_cell", "drop_tail"]


def _pair(x, cells, op):
    want = np.asarray(jseg.suffix_segment_reduce(
        jnp.asarray(x), jnp.asarray(cells, jnp.int32), op=op, chunk=CHUNK,
        interpret=True))
    got = segment.suffix_segment_reduce(
        torch.from_numpy(x), torch.from_numpy(cells.astype(np.int32)), op,
        CHUNK)
    return got, want


@pytest.mark.parametrize("kind", KINDS)
def test_max_f32_is_exact(kind):
    rng = np.random.default_rng(1)
    cells = _cells(kind, rng)
    x = rng.normal(size=(cells.size, 16)).astype(np.float32)
    got, want = _pair(x, cells, "max")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", KINDS)
def test_sum_f32_counts_exact(kind):
    """The frontends' xyzk stream: three coordinates and a 0/1 kept
    column."""
    rng = np.random.default_rng(2)
    cells = _cells(kind, rng)
    x = np.zeros((cells.size, 4), np.float32)
    kept = rng.random(cells.size) < 0.8
    x[:, :3] = rng.uniform(-50, 50, (cells.size, 3)) * kept[:, None]
    x[:, 3] = kept
    got, want = _pair(x, cells, "sum")
    got = got.numpy()
    np.testing.assert_array_equal(got[:, 3], want[:, 3])
    np.testing.assert_allclose(got[:, :3], want[:, :3], rtol=0,
                               atol=SUM_ATOL * np.abs(want).max())


TILED_N = 8192     # 8 kernel tiles of 1024 rows at C=4, 32 of 256 at C=64


def _tiled_cells(kind, rng):
    """Id streams long enough that K7's tile carry runs (the JAX kernel's
    own chunk is 1024), with runs over many tiles."""
    cells = np.sort(rng.integers(0, 300, TILED_N))
    if kind == "drop_most_tiles":          # the drop run from mid-tile on
        cells[1500:] = 300
    elif kind == "single_cell":
        cells[:] = 7
    elif kind == "negated_flipped":        # the prefix-sum stream of it
        cells[1500:] = 300
        cells = np.flip(-cells)
    elif kind == "runs_across_tiles":
        cells[700:3100] = cells[700]
        cells = np.sort(cells)
    return np.ascontiguousarray(cells).astype(np.int32)


@pytest.mark.parametrize("op,width", [("sum", 4), ("max", 64)])
@pytest.mark.parametrize("kind", ["drop_most_tiles", "single_cell",
                                  "negated_flipped", "runs_across_tiles"])
def test_tile_carry_matches_pallas(kind, op, width):
    """K7's plain version, in the kernel's order, where its tile carries
    chain over many tiles, against Pallas interpret with the JAX default
    chunk: the frontends' xyzk sums (counts exact, sums within SUM_ATOL of
    scale) and the 64-channel activation max (exact)."""
    rng = np.random.default_rng(6)
    cells = _tiled_cells(kind, rng)
    x = rng.normal(size=(TILED_N, width)).astype(np.float32) * 20
    if op == "sum":
        x[:, 3] = rng.random(TILED_N) < 0.8
        x[:, :3] *= x[:, 3:]
    want = np.asarray(jseg.suffix_segment_reduce(
        jnp.asarray(x), jnp.asarray(cells), op=op, chunk=1024,
        interpret=True))
    got = segment.suffix_segment_reduce_plain(
        torch.from_numpy(x), torch.from_numpy(cells), op, 1024).numpy()
    if op == "max":
        np.testing.assert_array_equal(got, want)
        return
    np.testing.assert_array_equal(got[:, 3], want[:, 3])
    np.testing.assert_allclose(got[:, :3], want[:, :3], rtol=0,
                               atol=SUM_ATOL * np.abs(want).max())


def test_max_bf16_is_exact():
    rng = np.random.default_rng(3)
    cells = _cells("runs_across_chunks", rng)
    x = rng.normal(size=(cells.size, 64)).astype(np.float32)
    want = np.asarray(jseg.suffix_segment_reduce(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(cells, jnp.int32),
        op="max", chunk=CHUNK, interpret=True).astype(jnp.float32))
    got = segment.suffix_segment_reduce(
        torch.from_numpy(x).to(torch.bfloat16),
        torch.from_numpy(cells.astype(np.int32)), "max", CHUNK)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_run_start_rows_hold_run_totals():
    """Every row holds its suffix; a run's first row its full total (the
    row the canvas reads) -- checked against a direct loop."""
    rng = np.random.default_rng(4)
    cells = _cells("runs_across_chunks", rng, n=512)
    x = rng.normal(size=(512, 3)).astype(np.float32)
    got = segment.suffix_segment_reduce(
        torch.from_numpy(x), torch.from_numpy(cells.astype(np.int32)), "max",
        CHUNK).numpy()
    for i in range(512):
        end = i + np.searchsorted(cells[i:], cells[i], side="right")
        np.testing.assert_array_equal(got[i], x[i:end].max(axis=0))


@pytest.mark.parametrize("op", ["max", "sum"])
def test_segment_reduce_canvas_matches_jax(op):
    rng = np.random.default_rng(5)
    num_cells = 200
    cells = np.sort(rng.integers(0, num_cells + 1, 2048))
    cells[cells == 17] = 18                        # an empty cell
    x = rng.normal(size=(2048, 8)).astype(np.float32)
    want_c, want_n = jseg.segment_reduce_canvas(
        jnp.asarray(x), jnp.asarray(cells, jnp.int32), num_cells, op=op,
        chunk=CHUNK, interpret=True)
    for reference in (False, True):
        got_c, got_n = segment.segment_reduce_canvas(
            torch.from_numpy(x), torch.from_numpy(cells.astype(np.int32)),
            num_cells, op=op, chunk=CHUNK, reference=reference)
        np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
        atol = 0 if op == "max" else SUM_ATOL * np.abs(want_c).max()
        np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0,
                                   atol=atol)
    assert int(got_n[17]) == 0 and not got_c[17].any()


def test_checks_match_the_jax_entry():
    x = torch.zeros((256, 4))
    cell = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError, match="op"):
        segment.suffix_segment_reduce(x, cell, "min", CHUNK)
    with pytest.raises(ValueError, match="divisible"):
        segment.suffix_segment_reduce(x[:200], cell[:200], "max", CHUNK)
    with pytest.raises(ValueError, match="bfloat16"):
        segment.suffix_segment_reduce(x.bfloat16(), cell, "sum", CHUNK)
    with pytest.raises(ValueError, match="int32"):
        segment.suffix_segment_reduce(x, cell.long(), "max", CHUNK)
    assert segment.suffix_segment_reduce.launches == 0   # CPU: plain path
