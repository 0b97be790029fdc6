"""Binning, the affine PFN split and the affine canvas of the port against
the JAX package (`affine_canvas` with the Pallas kernels in interpret
mode; its XLA path in test_torch_canvas_xla.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gndnet_tpu.config import GndNetConfig as JaxConfig
from gndnet_tpu.ops import pillarize as jpz
from gndnet_tpu_torch.config import GndNetConfig
from gndnet_tpu_torch.ops import pillarize as pz

GRIDS = {
    "16x16": dict(pc_range=(0.0, -8.0, -4.0, 16.0, 8.0, 4.0),
                  voxel_size=(1.0, 1.0, 8.0)),
    "13x10": dict(pc_range=(-3.0, -2.0, -4.0, 2.2, 2.0, 4.0),
                  voxel_size=(0.4, 0.4, 8.0)),
}
CAP = 20


def _geoms(grid):
    return (jpz.PillarGeometry.from_config(JaxConfig(**GRIDS[grid])),
            pz.PillarGeometry.from_config(GndNetConfig(**GRIDS[grid])))


def _cloud(rng, geom, n, dense=True):
    """Points inside and around the box, with a dense cell (more points
    than the cap) and duplicated points."""
    lo = np.asarray(geom.pc_range[:3])
    hi = np.asarray(geom.pc_range[3:])
    span = hi - lo
    pts = np.zeros((n, 4), np.float32)
    pts[:, :3] = rng.uniform(lo - 0.1 * span, hi + 0.1 * span, (n, 3))
    pts[:, 3] = rng.uniform(0, 1, n)
    if dense and n >= 200:
        pts[:60, :3] = lo + 0.5 * np.asarray(geom.voxel_size) \
            + rng.uniform(-0.2, 0.2, (60, 3)) * np.asarray(geom.voxel_size)
        pts[60:120] = pts[rng.integers(120, n, 60)]
    return pts


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_binning_is_exact(grid):
    jgeom, geom = _geoms(grid)
    rng = np.random.default_rng(0)
    pts = _cloud(rng, jgeom, 800)
    pts[0, :3] = jgeom.pc_range[:3]                     # lower edges: in
    pts[1, :3] = jgeom.pc_range[3:]                     # upper edges: out
    pts_b = np.stack([pts, _cloud(rng, jgeom, 800)])
    for jctx, ctx in (
            (jpz.bin_points(jnp.asarray(pts), jgeom),
             pz.bin_points(torch.from_numpy(pts), geom)),
            (jpz.bin_points_batch(jnp.asarray(pts_b), jgeom),
             pz.bin_points_batch(torch.from_numpy(pts_b), geom))):
        for name in ("cx", "cy", "cz", "cell", "valid"):
            np.testing.assert_array_equal(
                getattr(ctx, name).numpy(), np.asarray(getattr(jctx, name)),
                err_msg=name)
        assert (ctx.num_segments, ctx.batch) == (jctx.num_segments,
                                                 jctx.batch)
    assert bool(ctx.valid[0]) and not bool(ctx.valid[1])


@pytest.mark.parametrize("with_distance", [False, True])
def test_affine_pfn_weights_are_exact(with_distance):
    jgeom, geom = _geoms("16x16")
    rng = np.random.default_rng(1)
    rows = 4 + 5 + int(with_distance)
    kernel = rng.normal(size=(rows, 64)).astype(np.float32)
    bias = rng.normal(size=64).astype(np.float32)
    want = jpz.affine_pfn_weights(jnp.asarray(kernel), jnp.asarray(bias), 4,
                                  jgeom, with_distance)
    got = pz.affine_pfn_weights(torch.from_numpy(kernel),
                                torch.from_numpy(bias), 4, geom,
                                with_distance)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _canvases(pts, grid, dtype="float32", exact_point_cap=True,
              with_distance=False, xla=False):
    jgeom, geom = _geoms(grid)
    rng = np.random.default_rng(9)
    rows = pts.shape[1] + 5 + int(with_distance)
    kernel = (rng.normal(size=(rows, 64)) * 0.5).astype(np.float32)
    bias = rng.normal(size=64).astype(np.float32)
    want = jpz.affine_canvas(
        jnp.asarray(pts), jpz.bin_points(jnp.asarray(pts), jgeom), jgeom,
        CAP, jnp.asarray(kernel), jnp.asarray(bias),
        with_distance=with_distance, exact_point_cap=exact_point_cap,
        compute_dtype=jnp.dtype(dtype), use_pallas=not xla,
        interpret=not xla)
    tpts = torch.from_numpy(pts)
    got = pz.affine_canvas(
        tpts, pz.bin_points(tpts, geom), geom, CAP,
        torch.from_numpy(kernel), torch.from_numpy(bias),
        with_distance=with_distance, exact_point_cap=exact_point_cap,
        compute_dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (1, geom.ny, geom.nx, 64)
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("exact_point_cap", [True, False])
def test_canvas_matches_pallas_interpret(grid, exact_point_cap):
    pts = _cloud(np.random.default_rng(3), _geoms(grid)[0], 1000)
    got, want = _canvases(pts, grid, exact_point_cap=exact_point_cap)
    assert (want != 0).any(axis=-1).sum() > 50
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_canvas_bf16_and_distance():
    pts = _cloud(np.random.default_rng(5), _geoms("16x16")[0], 1000)
    got, want = _canvases(pts, "16x16", dtype="bfloat16")
    # the same bf16 roundings, but bf16 sums of the epilogue may round
    # differently: one bf16 ulp of the largest entries
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 ** -7 * np.abs(want).max())
    got, want = _canvases(pts, "16x16", with_distance=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["all_invalid", "one_valid", "single_point"])
def test_canvas_edge_scans(case):
    pts = np.full((1000, 4), 1e9, np.float32)
    if case == "one_valid":
        pts[517] = (3.5, 2.5, 0.0, 0.5)
    elif case == "single_point":
        pts = np.array([[3.5, 2.5, 0.0, 0.5]], np.float32)
    got, want = _canvases(pts, "16x16")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    occupied = (got != 0).any(axis=-1).sum()
    assert occupied == (0 if case == "all_invalid" else 1)
