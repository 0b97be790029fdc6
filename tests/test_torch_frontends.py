"""The 'scatter' and 'sorted' frontends of the port against the JAX package
on the CPU (the sorted one with K7 in interpret mode, chunk 128), at B=1
and B=2, with both cap settings and with and without the distance feature,
and the scatter canvas's gradient against `jax.grad` where points repeat.

Tolerances: ranks, kept sets, sorted ids and counts identical; decorated
features within 1e-5 (sorted: the run means come from K7 sums in another
order); canvases from the same activations identical; sorted against
scatter at the JAX package's own rtol 1e-4 / atol 1e-5
(tests/test_pillarize.py:277-279)."""

import jax
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
CAP, CHUNK, WIDTH = 20, 128, 16


def _geoms(grid):
    return (jpz.PillarGeometry.from_config(JaxConfig(**GRIDS[grid])),
            pz.PillarGeometry.from_config(GndNetConfig(**GRIDS[grid])))


def _cloud(rng, geom, n):
    """In and around the box, a cell over the cap, ~40% repeated points."""
    lo, hi = np.asarray(geom.pc_range[:3]), np.asarray(geom.pc_range[3:])
    span = hi - lo
    pts = np.zeros((n, 4), np.float32)
    pts[:, :3] = rng.uniform(lo - 0.1 * span, hi + 0.1 * span, (n, 3))
    pts[:, 3] = rng.uniform(0, 1, n)
    pts[:40, :3] = lo + np.asarray(geom.voxel_size) * (
        0.5 + rng.uniform(-0.2, 0.2, (40, 3)))
    dup = rng.random(n) < 0.4
    pts[dup] = pts[rng.integers(0, n, int(dup.sum()))]
    return pts


def _batch(grid, b, n=500, seed=0):
    rng = np.random.default_rng(seed)
    jgeom, _ = _geoms(grid)
    pts = np.stack([_cloud(rng, jgeom, n) for _ in range(b)])
    if b > 1:
        pts[-1, n // 3:] = 1e9                     # a sparse item
    return pts


def _ctxs(pts, grid):
    jgeom, geom = _geoms(grid)
    return (jpz.bin_points_batch(jnp.asarray(pts), jgeom),
            pz.bin_points_batch(torch.from_numpy(pts), geom))


def _acts(decorated, seed=9):
    """The same activations for both sides: relu(dec @ w + b) in numpy."""
    rng = np.random.default_rng(seed)
    d = decorated.shape[1]
    w = (rng.normal(size=(d, WIDTH)) * 0.3).astype(np.float32)
    b = (rng.normal(size=WIDTH) * 0.3).astype(np.float32)
    acts = np.maximum(decorated @ w + b, 0).astype(np.float32)
    return acts, np.maximum(b, 0).astype(np.float32)


@pytest.mark.parametrize("b", [1, 2])
def test_point_ranks_exact(b):
    pts = _batch("16x16", b)
    jctx, ctx = _ctxs(pts, "16x16")
    np.testing.assert_array_equal(pz.point_ranks(ctx).numpy(),
                                  np.asarray(jpz.point_ranks(jctx)))


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("exact_point_cap,with_distance",
                         [(True, False), (False, False), (True, True)])
def test_scatter_frontend_and_canvas(grid, b, exact_point_cap,
                                     with_distance):
    pts = _batch(grid, b, seed=b)
    jgeom, geom = _geoms(grid)
    jctx, ctx = _ctxs(pts, grid)
    flat = pts.reshape(-1, 4)
    jdec, jkept, jcount = jpz.fused_frontend(
        jnp.asarray(flat), jctx, jgeom, CAP, with_distance=with_distance,
        exact_point_cap=exact_point_cap)
    dec, kept, count = pz.fused_frontend(
        torch.from_numpy(flat), ctx, geom, CAP, with_distance=with_distance,
        exact_point_cap=exact_point_cap)
    np.testing.assert_array_equal(kept.numpy(), np.asarray(jkept))
    np.testing.assert_array_equal(count.numpy(), np.asarray(jcount))
    assert (int(count.max()) == CAP) == exact_point_cap   # a cell over the cap
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), rtol=0,
                               atol=1e-5)

    acts, floor = _acts(np.asarray(jdec))
    want = jpz.canvas_from_activations(
        jnp.asarray(acts), jctx, jkept, jcount, jgeom, CAP,
        pad_floor=jnp.asarray(floor))
    got = pz.canvas_from_activations(
        torch.from_numpy(acts), ctx, kept, count, geom, CAP,
        pad_floor=torch.from_numpy(floor))
    assert tuple(got.shape) == (b, geom.ny, geom.nx, WIDTH)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("exact_point_cap,with_distance",
                         [(True, False), (False, True)])
def test_sorted_frontend_and_canvas(grid, b, exact_point_cap, with_distance):
    pts = _batch(grid, b, seed=10 + b)
    jgeom, geom = _geoms(grid)
    jctx, ctx = _ctxs(pts, grid)
    flat = pts.reshape(-1, 4)
    jdec, jkept, jcell, jcount = jpz.fused_frontend_sorted(
        jnp.asarray(flat), jctx, jgeom, CAP, with_distance=with_distance,
        exact_point_cap=exact_point_cap, chunk=CHUNK, interpret=True)
    dec, kept, cell, count = pz.fused_frontend_sorted(
        torch.from_numpy(flat), ctx, geom, CAP, with_distance=with_distance,
        exact_point_cap=exact_point_cap, chunk=CHUNK)
    assert dec.shape[0] % CHUNK == 0 and dec.shape[0] >= flat.shape[0]
    np.testing.assert_array_equal(kept.numpy(), np.asarray(jkept))
    np.testing.assert_array_equal(cell.numpy(), np.asarray(jcell))
    np.testing.assert_array_equal(count.numpy(), np.asarray(jcount))
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), rtol=0,
                               atol=1e-5)

    acts, floor = _acts(np.asarray(jdec))
    want = jpz.canvas_from_sorted_activations(
        jnp.asarray(acts), jkept, jcell, jcount, jctx, jgeom, CAP,
        pad_floor=jnp.asarray(floor), chunk=CHUNK, interpret=True)
    got = pz.canvas_from_sorted_activations(
        torch.from_numpy(acts), kept, cell, count, ctx, geom, CAP,
        pad_floor=torch.from_numpy(floor), chunk=CHUNK)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    # and against the port's own scatter frontend
    sdec, skept, scount = pz.fused_frontend(
        torch.from_numpy(flat), ctx, geom, CAP, with_distance=with_distance,
        exact_point_cap=exact_point_cap)
    np.testing.assert_array_equal(scount.numpy(), count.numpy())
    sacts, _ = _acts(sdec.numpy())
    scatter = pz.canvas_from_activations(
        torch.from_numpy(sacts), ctx, skept, scount, geom, CAP,
        pad_floor=torch.from_numpy(floor))
    np.testing.assert_allclose(got.numpy(), scatter.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_sorted_frontend_reference_path_is_the_same():
    """`reference=True` (K7's plain version) gives the same bits on the
    CPU, where the wrapper also takes the plain version."""
    pts = _batch("16x16", 2, seed=3)
    _, geom = _geoms("16x16")
    _, ctx = _ctxs(pts, "16x16")
    flat = torch.from_numpy(pts.reshape(-1, 4))
    a = pz.fused_frontend_sorted(flat, ctx, geom, CAP, chunk=CHUNK)
    r = pz.fused_frontend_sorted(flat, ctx, geom, CAP, chunk=CHUNK,
                                 reference=True)
    for x, y in zip(a, r):
        assert torch.equal(x, y)


def test_scatter_canvas_gradient_splits_ties_as_jax():
    """d(loss)/d(acts) and d(loss)/d(pad_floor) of the scatter canvas:
    repeated points tie inside a cell's max (the cotangent splits equally
    among them), and one non-full cell's max equals the floor in every
    channel (1/2 : 1/2)."""
    pts = _batch("16x16", 1, seed=21)
    jgeom, geom = _geoms("16x16")
    jctx, ctx = _ctxs(pts, "16x16")
    flat = pts.reshape(-1, 4)
    jdec, jkept, jcount = jpz.fused_frontend(jnp.asarray(flat), jctx, jgeom,
                                             CAP)
    acts, floor = _acts(np.asarray(jdec))
    count = np.array(jcount)
    cell = np.asarray(jctx.cell)
    # a non-full cell with a repeated point: set the floor to its max
    tied = next(c for c in np.unique(cell[np.asarray(jkept)])
                if 1 < count[c] < CAP and len(np.unique(
                    flat[cell == c], axis=0)) < (cell == c).sum())
    floor = acts[(cell == tied) & np.asarray(jkept)].max(axis=0)
    wts = np.random.default_rng(5).normal(
        size=(1, geom.ny, geom.nx, WIDTH)).astype(np.float32)

    def jloss(a, f):
        c = jpz.canvas_from_activations(a, jctx, jkept, jcount, jgeom, CAP,
                                        pad_floor=f)
        return jnp.sum(c * wts)

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(acts),
                                           jnp.asarray(floor))
    a = torch.from_numpy(acts).requires_grad_()
    f = torch.from_numpy(floor).requires_grad_()
    canvas = pz.canvas_from_activations(
        a, ctx, torch.from_numpy(np.array(jkept)),
        torch.from_numpy(count), geom, CAP, pad_floor=f)
    (canvas * torch.from_numpy(wts)).sum().backward()
    ga, gf = a.grad.numpy(), f.grad.numpy()
    np.testing.assert_allclose(ga, np.asarray(want[0]), rtol=0, atol=1e-6)
    # the floor's gradient sums over every non-full cell: another order
    np.testing.assert_allclose(gf, np.asarray(want[1]), rtol=0,
                               atol=1e-6 * np.abs(want[1]).max())
    # in the tied cell no row takes the whole cotangent: at most half
    w_cell = np.abs(wts[0, tied // geom.nx, tied % geom.nx])
    share = np.abs(ga[cell == tied]).max(axis=0)
    assert (share > 0).all()
    np.testing.assert_array_less(share, 0.5001 * w_cell)
