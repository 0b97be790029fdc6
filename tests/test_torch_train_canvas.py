"""The training canvas of the port against the JAX package: d(kernel) and
d(bias) through `affine_canvas` at B=1 and B=3 against `jax.grad` through
the JAX `affine_canvas(differentiable=True, interpret=True)` (its custom
VJP with the Pallas kernels in interpret mode), the batched forward, and
the train-mode forward against the serving one."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gndnet_tpu.config import GndNetConfig as JaxConfig
from gndnet_tpu.ops import pillarize as jpz
from gndnet_tpu_torch.config import GndNetConfig
from gndnet_tpu_torch.ops import pillarize as pz

GRID = dict(pc_range=(0.0, -8.0, -4.0, 16.0, 8.0, 4.0),
            voxel_size=(1.0, 1.0, 8.0))
JGEOM = jpz.PillarGeometry.from_config(JaxConfig(**GRID))
GEOM = pz.PillarGeometry.from_config(GndNetConfig(**GRID))
CAP, WIDTH = 20, 32
# d(kernel), d(bias) tolerance as a share of the largest gradient.  f32
# differs only in summation order.  In bf16, d(kernel) stays within 4e-3;
# d(bias) is the sum over every cell of the bf16 cotangent of the broadcast
# bias, which XLA's CPU reduction adds up in bf16 while the port sums in f32
# and rounds once: measured 1.0e-2 of scale apart, so bf16 d(bias) is held
# to 2e-2 and to being no further from the f32 gradient than JAX's is.
GRAD_ATOL = {"float32": (1e-5, 1e-5), "bfloat16": (4e-3, 2e-2)}


def _cloud(rng, n):
    """In and around the box, a cell over the cap, ~45% duplicated rows."""
    pts = np.zeros((n, 4), np.float32)
    pts[:, :3] = rng.uniform((-1.6, -9.6, -4.8), (17.6, 9.6, 4.8), (n, 3))
    pts[:, 3] = rng.uniform(0, 1, n)
    pts[:40, :3] = (3.5, 2.5, 0.0) + rng.uniform(-0.4, 0.4, (40, 3))
    dup = rng.random(n) < 0.45
    pts[dup] = pts[rng.integers(0, n, int(dup.sum()))]
    return pts


def _batch(b, n=600, seed=0):
    rng = np.random.default_rng(seed)
    pts = np.stack([_cloud(rng, n) for _ in range(b)])
    if b > 1:
        pts[-1, n // 3:] = 1e9                  # a sparse item
    kernel = (rng.normal(size=(9, WIDTH)) * 0.5).astype(np.float32)
    bias = (rng.normal(size=WIDTH) * 0.5).astype(np.float32)
    wts = rng.normal(size=(b, GEOM.ny, GEOM.nx, WIDTH)).astype(np.float32)
    return pts, kernel, bias, wts


@functools.lru_cache(maxsize=None)
def _jax_case(b, dtype):
    """The JAX canvas and grads of `_batch(b, seed=b)`, computed once."""
    return _jax(*_batch(b, seed=b), dtype)


def _jax(pts, kernel, bias, wts, dtype):
    ctx = jpz.bin_points_batch(jnp.asarray(pts), JGEOM)
    flat = jnp.asarray(pts.reshape(-1, 4))

    def loss(k, b):
        c = jpz.affine_canvas(flat, ctx, JGEOM, CAP, k, b,
                              compute_dtype=jnp.dtype(dtype),
                              differentiable=True, interpret=True)
        return jnp.sum(c.astype(jnp.float32) * wts), c

    (_, canvas), grads = jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True)(
        jnp.asarray(kernel), jnp.asarray(bias))
    return (np.asarray(canvas.astype(jnp.float32)),
            [np.asarray(g) for g in grads])


def _port(pts, kernel, bias, wts, dtype, grad=True):
    t = torch.from_numpy(pts)
    k = torch.from_numpy(kernel).requires_grad_(grad)
    b = torch.from_numpy(bias).requires_grad_(grad)
    with torch.set_grad_enabled(grad):
        canvas = pz.affine_canvas(t.reshape(-1, 4),
                                  pz.bin_points_batch(t, GEOM), GEOM, CAP,
                                  k, b, compute_dtype=getattr(torch, dtype))
    if not grad:
        return canvas, None
    (canvas.float() * torch.from_numpy(wts)).sum().backward()
    return canvas, [k.grad.numpy(), b.grad.numpy()]


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_canvas_vjp_matches_jax(b, dtype):
    pts, kernel, bias, wts = _batch(b, seed=b)
    want_canvas, want = _jax_case(b, dtype)
    canvas, got = _port(pts, kernel, bias, wts, dtype)
    assert canvas.shape == (b, GEOM.ny, GEOM.nx, WIDTH)
    assert canvas.dtype == getattr(torch, dtype)
    # the forward: exact scan values, the bf16 epilogue within one ulp
    atol = 1e-5 if dtype == "float32" else 2**-7 * np.abs(want_canvas).max()
    np.testing.assert_allclose(canvas.detach().float().numpy(), want_canvas,
                               rtol=0, atol=atol)
    for g, w, tol in zip(got, want, GRAD_ATOL[dtype]):
        scale = np.abs(w).max()
        assert scale > 0
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale)
    if dtype == "bfloat16":
        exact = _jax_case(b, "float32")[1][1]
        assert np.abs(got[1] - exact).max() <= np.abs(want[1] - exact).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_canvas_equals_serving_canvas(dtype):
    """With autograd on, the scan runs K4/K5 (argmax-tracking) instead of
    K2; the canvas must not change by a single bit."""
    pts, kernel, bias, wts = _batch(2, seed=7)
    train, _ = _port(pts, kernel, bias, wts, dtype)
    serve, _ = _port(pts, kernel, bias, wts, dtype, grad=False)
    assert train.requires_grad and not serve.requires_grad
    bits = torch.int16 if dtype == "bfloat16" else torch.int32
    assert torch.equal(train.detach().view(bits), serve.view(bits))


def test_batched_canvas_matches_jax_and_per_scan():
    """B=3 in one call (the batched sort) against the JAX canvas and
    against three B=1 calls (the K1 path)."""
    pts, kernel, bias, _ = _batch(3, seed=4)
    k, b = torch.from_numpy(kernel), torch.from_numpy(bias)
    t = torch.from_numpy(pts)
    got = pz.affine_canvas(t.reshape(-1, 4), pz.bin_points_batch(t, GEOM),
                           GEOM, CAP, k, b)
    want = jpz.affine_canvas(
        jnp.asarray(pts.reshape(-1, 4)),
        jpz.bin_points_batch(jnp.asarray(pts), JGEOM), JGEOM, CAP,
        jnp.asarray(kernel), jnp.asarray(bias), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    for i in range(3):
        one = pz.affine_canvas(t[i], pz.bin_points(t[i], GEOM), GEOM, CAP,
                               k, b)
        assert torch.equal(one[0], got[i])
    occupied = (got != 0).any(dim=-1).sum(dim=(1, 2))
    assert (occupied > 0).all() and occupied[2] < occupied[0]
