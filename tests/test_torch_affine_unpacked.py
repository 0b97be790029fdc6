"""The affine canvas of the port on a grid whose packed (cell, index) key
overflows 31 bits (fine_grid's case): K10's (cell, iota) pair sort at B=1,
the stable batched sort at B>1, against the JAX `affine_canvas` with its
Pallas kernels in interpret mode, which takes the same branches.

The grid is 182 x 182 cells of 0.1 m (33 124 cells) and the scans hold
32 769 points, so the index field needs 16 bits and the key
33 124 * 2^16 + 32 768 >= 2^31.  fine_grid's own shapes (62 500 cells,
102 400 points) run on the card (chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gndnet_tpu.config import GndNetConfig as JaxConfig
from gndnet_tpu.ops import pillarize as jpz
from gndnet_tpu_torch.config import GndNetConfig
from gndnet_tpu_torch.ops import pillarize as pz
from gndnet_tpu_torch.ops import sort

GRID = dict(pc_range=(0.0, -9.1, -4.0, 18.2, 9.1, 4.0),
            voxel_size=(0.1, 0.1, 8.0))
JGEOM = jpz.PillarGeometry.from_config(JaxConfig(**GRID))
GEOM = pz.PillarGeometry.from_config(GndNetConfig(**GRID))
N, CAP, WIDTH = 32_769, 20, 32


def test_the_grid_overflows_the_packed_key():
    idxcap = 1 << (N - 1).bit_length()
    assert (GEOM.nx, GEOM.ny) == (182, 182)
    assert GEOM.num_cells_3d * idxcap + N - 1 >= 2**31


def _batch(b, seed):
    """In and around the box, two cells over the cap (60 and 40 points),
    ~30% duplicated rows; the last item of a batch sparse."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((b, N, 4), np.float32)
    pts[..., :3] = rng.uniform((-1.8, -11.0, -4.8), (20.0, 11.0, 4.8),
                               (b, N, 3))
    pts[..., 3] = rng.uniform(0, 1, (b, N))
    pts[:, :60, :3] = (3.55, 2.55, 0.0) + rng.uniform(-0.04, 0.04, (b, 60, 3))
    pts[:, 60:100, :3] = (9.05, -4.05, 1.0) + rng.uniform(-0.04, 0.04,
                                                          (b, 40, 3))
    for i in range(b):
        dup = rng.random(N) < 0.3
        pts[i, dup] = pts[i, rng.integers(0, N, int(dup.sum()))]
    if b > 1:
        pts[-1, N // 2:] = 1e9
    kernel = (rng.normal(size=(9, WIDTH)) * 0.5).astype(np.float32)
    bias = (rng.normal(size=WIDTH) * 0.5).astype(np.float32)
    return pts, kernel, bias


def _jax_canvas(pts, kernel, bias, dtype="float32"):
    ctx = jpz.bin_points_batch(jnp.asarray(pts), JGEOM)
    return np.asarray(jpz.affine_canvas(
        jnp.asarray(pts.reshape(-1, 4)), ctx, JGEOM, CAP,
        jnp.asarray(kernel), jnp.asarray(bias),
        compute_dtype=jnp.dtype(dtype), interpret=True).astype(jnp.float32))


class _Calls:
    """Counts the calls of the two B=1 sorts the canvas may dispatch."""

    def __init__(self, monkeypatch):
        self.n = {"sort_i32": 0, "sort2_i32": 0}
        for name in self.n:
            fn = getattr(sort, name)
            monkeypatch.setattr(sort, name, self._count(name, fn))

    def _count(self, name, fn):
        def wrapped(*args):
            self.n[name] += 1
            return fn(*args)
        return wrapped


@pytest.mark.parametrize("b", [1, 2])
def test_unpacked_canvas_matches_pallas(b, monkeypatch):
    """float32 canvas within 1e-5, as test_torch_pillarize.py holds the
    packed path; B=1 dispatches K10 and not K1, B=2 neither."""
    pts, kernel, bias = _batch(b, seed=b)
    calls = _Calls(monkeypatch)
    t = torch.from_numpy(pts)
    got = pz.affine_canvas(t.reshape(-1, 4), pz.bin_points_batch(t, GEOM),
                           GEOM, CAP, torch.from_numpy(kernel),
                           torch.from_numpy(bias))
    assert calls.n == {"sort_i32": 0, "sort2_i32": int(b == 1)}
    want = _jax_canvas(pts, kernel, bias)
    assert tuple(got.shape) == (b, 182, 182, WIDTH)
    assert ((want != 0).any(axis=-1).sum(axis=(1, 2)) > 5_000).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_unpacked_canvas_bf16():
    """The same bf16 roundings; the bf16 epilogue within one bf16 ulp of
    the largest entries, as on the packed path."""
    pts, kernel, bias = _batch(1, seed=5)
    t = torch.from_numpy(pts)
    got = pz.affine_canvas(t.reshape(-1, 4), pz.bin_points_batch(t, GEOM),
                           GEOM, CAP, torch.from_numpy(kernel),
                           torch.from_numpy(bias),
                           compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = _jax_canvas(pts, kernel, bias, "bfloat16")
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2 ** -7 * np.abs(want).max())


@pytest.mark.parametrize("b", [1, 2])
def test_unpacked_stream_keeps_the_first_points_of_each_cell(b):
    """The cell-sorted stream lists each cell's points in scan order, so
    its first min(count, cap) rows per cell are the JAX scatter frontend's
    kept set (rank < cap in stream order), and the counts are the cells'
    point counts."""
    pts, _, _ = _batch(b, seed=10 + b)
    t = torch.from_numpy(pts)
    ctx = pz.bin_points_batch(t, GEOM)
    spts, starts, counts = pz.cell_stream(t.reshape(-1, 4), ctx, GEOM)
    local = np.where(ctx.valid.numpy(), ctx.cell.numpy()
                     - np.repeat(np.arange(b), N) * GEOM.num_cells_3d,
                     GEOM.num_cells_3d).reshape(b, N)
    order = np.argsort(local, axis=1, kind="stable")
    np.testing.assert_array_equal(
        spts.numpy().reshape(b, N, 4),
        np.take_along_axis(pts, order[..., None], axis=1))
    np.testing.assert_array_equal(
        counts.numpy().reshape(b, -1),
        np.stack([np.bincount(row[row < GEOM.num_cells_3d],
                              minlength=GEOM.num_cells_3d) for row in local]))
    jctx = jpz.bin_points_batch(jnp.asarray(pts), JGEOM)
    _, jkept, _ = jpz.fused_frontend(jnp.asarray(pts.reshape(-1, 4)), jctx,
                                     JGEOM, CAP)
    kept = np.zeros(b * N, bool)
    starts, counts = starts.numpy(), counts.numpy()
    flat_order = (order + np.arange(b)[:, None] * N).reshape(-1)
    for s, c in zip(starts[counts > 0], counts[counts > 0]):
        kept[flat_order[s:s + min(c, CAP)]] = True
    np.testing.assert_array_equal(kept, np.asarray(jkept))
    assert counts.max() > CAP
