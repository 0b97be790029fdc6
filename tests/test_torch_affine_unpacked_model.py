"""The port on a grid whose packed (cell, index) key overflows 31 bits,
above the canvas: the B=2 training canvas gradient against `jax.grad`,
`GroundEstimatorNet.fused` at B=2 and one engine `infer` against the JAX
package; the grid and scans of test_torch_affine_unpacked.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gndnet_tpu.checkpoint import import_torch_state_dict
from gndnet_tpu.config import GndNetConfig as JaxConfig
from gndnet_tpu.infer import GroundInferenceEngine as JaxEngine
from gndnet_tpu.models.gndnet import GroundEstimatorNet as JaxNet
from gndnet_tpu.ops import pillarize as jpz
from gndnet_tpu_torch.config import GndNetConfig
from gndnet_tpu_torch.infer import GroundInferenceEngine
from gndnet_tpu_torch.models.gndnet import GroundEstimatorNet
from gndnet_tpu_torch.ops import pillarize as pz
from gndnet_tpu_torch.weights import init_state_dict
from test_torch_affine_unpacked import (CAP, GEOM, GRID, JGEOM, N, WIDTH,
                                        _batch)
from test_torch_infer import THRESHOLD, scene


def test_unpacked_train_canvas_gradient_matches_jax():
    """B=2 through the stable batched sort with autograd: d(kernel) and
    d(bias) against `jax.grad` of the JAX canvas (its custom VJP, Pallas
    in interpret mode) within 1e-5 of scale, as test_torch_train_canvas.py
    holds the packed path."""
    pts, kernel, bias = _batch(2, seed=7)
    wts = np.random.default_rng(8).normal(
        size=(2, GEOM.ny, GEOM.nx, WIDTH)).astype(np.float32)
    ctx = jpz.bin_points_batch(jnp.asarray(pts), JGEOM)
    flat = jnp.asarray(pts.reshape(-1, 4))

    def loss(k, b):
        c = jpz.affine_canvas(flat, ctx, JGEOM, CAP, k, b,
                              differentiable=True, interpret=True)
        return jnp.sum(c * wts)

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(kernel),
                                          jnp.asarray(bias))
    t = torch.from_numpy(pts)
    k = torch.from_numpy(kernel).requires_grad_(True)
    b = torch.from_numpy(bias).requires_grad_(True)
    canvas = pz.affine_canvas(t.reshape(-1, 4), pz.bin_points_batch(t, GEOM),
                              GEOM, CAP, k, b)
    (canvas * torch.from_numpy(wts)).sum().backward()
    for g, w in zip((k.grad, b.grad), want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


# the 16x16 engine config of test_torch_infer.py on the overflowing grid
SMALL = dict(pc_range=GRID["pc_range"], voxel_size=GRID["voxel_size"],
             grid_range=(0.0, -9.1, 18.2, 9.1), max_points_voxel=CAP,
             max_voxels=4096, input_features=4, num_points=N,
             lidar_height=1.7, use_norm=False, fused_impl="affine",
             compute_dtype="float32", matmul_precision="highest")


@pytest.fixture(scope="module")
def models():
    """The port's seeded weights with random BN statistics, and the same
    weights as JAX variables through the JAX package's importer."""
    jcfg, cfg = JaxConfig(**SMALL), GndNetConfig(**SMALL)
    sd = init_state_dict(cfg, seed=0)
    rng = np.random.default_rng(0)
    for name, t in sd.items():
        if name.endswith("running_mean"):
            t.copy_(torch.from_numpy(rng.normal(0, 0.1, t.shape)))
        elif name.endswith("running_var"):
            t.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, t.shape)))
    return jcfg, cfg, import_torch_state_dict(sd, jcfg), sd


def test_overflow_grid_fused_and_engine_match_jax(models):
    """`fused` at B=2 (the stable batched sort) and one engine `infer` at
    B=1 (K10's pair sort) against the JAX package, float32 / 'highest'.
    The canvases agree to a few 1e-6 (their xyz sums run in other
    orders), and with random weights the SegNet's max-pool argmax routing
    can turn such a gap into up to 1e-2 of elevation at a near-tied window
    (chip_smoke.py's IMPL_ELEV_ATOL): so the largest gap is held to 1e-2,
    the median to 1e-6, and labels must agree away from the threshold."""
    jcfg, cfg, variables, sd = models
    rng = np.random.default_rng(1)
    scans = np.stack([scene(rng, N) for _ in range(2)])
    net = GroundEstimatorNet(cfg, device="cpu")
    net.load_state_dict(sd)
    got = net.fused(torch.from_numpy(scans)).numpy()
    want = np.asarray(JaxNet(jcfg).apply(
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(scans),
        method=JaxNet.fused))
    jeng = JaxEngine(jcfg, variables, threshold=THRESHOLD, bucket=4096)
    teng = GroundInferenceEngine(cfg, sd, threshold=THRESHOLD, bucket=4096,
                                 device="cpu")
    (ej, lj), (et, lt) = jeng.infer(scans[0]), teng.infer(scans[0])
    assert got.shape == (2, 182, 182) and et.shape == (182, 182)
    assert lt.shape == (N,) and set(np.unique(lt)) == {-1, 0, 1}
    for g, w in ((got, want), (et, ej)):
        gap = np.abs(g - w)
        assert gap.max() <= 1e-2 and np.median(gap) <= 1e-6, gap.max()
    diff = np.flatnonzero(lt != lj)
    ix = np.floor((scans[0, diff, 0] - 0.0) / 0.1).astype(int)
    iy = np.floor((scans[0, diff, 1] + 9.1) / 0.1).astype(int)
    margin = np.abs(scans[0, diff, 2] + 1.7 - ej.T[ix, iy] - THRESHOLD)
    assert (margin <= np.abs(et - ej).max() + 1e-5).all()
