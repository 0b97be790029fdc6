"""The whole slice: the port's GroundInferenceEngine against the JAX engine
(fused_impl='affine', float32, 'highest'), and segment_cloud."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gndnet_tpu.config import GndNetConfig as JaxConfig
from gndnet_tpu.infer import GroundInferenceEngine as JaxEngine
from gndnet_tpu.models.gndnet import init_model
from gndnet_tpu.ops.postproc import segment_cloud as jax_segment_cloud
from gndnet_tpu_torch.config import GndNetConfig
from gndnet_tpu_torch.infer import GroundInferenceEngine
from gndnet_tpu_torch.ops.postproc import segment_cloud
from gndnet_tpu_torch.weights import state_dict_from_flax

# the 16x16 config of tests/test_infer_eval.py, on the affine path
SMALL = dict(pc_range=(0.0, -8.0, -4.0, 16.0, 8.0, 4.0),
             grid_range=(0.0, -8.0, 16.0, 8.0), voxel_size=(1.0, 1.0, 8.0),
             max_points_voxel=20, max_voxels=256, input_features=4,
             num_points=512, lidar_height=1.7, use_norm=False,
             fused_impl="affine", compute_dtype="float32",
             matmul_precision="highest")
THRESHOLD = 0.08


def scene(rng, n=700):
    """Ground plane at -lidar_height, two boxes, a dense patch over the cap,
    points out of range."""
    pts = np.zeros((n, 4), np.float32)
    pts[:, 0] = rng.uniform(-1.0, 17.0, n)
    pts[:, 1] = rng.uniform(-9.0, 9.0, n)
    pts[:, 2] = -1.7 + rng.normal(0, 0.02, n)
    box = slice(0, n // 4)
    pts[box, 0] = rng.uniform(5, 7, n // 4)
    pts[box, 1] = rng.uniform(-2, 1, n // 4)
    pts[box, 2] = rng.uniform(-1.7, 0.3, n // 4)
    pts[n // 4:n // 4 + 60, :2] = rng.uniform(10.1, 10.9, (60, 2))
    pts[:, 3] = rng.uniform(0, 1, n)
    return pts


@pytest.fixture(scope="module")
def engines():
    jcfg, cfg = JaxConfig(**SMALL), GndNetConfig(**SMALL)
    _, variables = init_model(jcfg, seed=0)
    variables = jax.tree_util.tree_map(np.array, variables)
    rng = np.random.default_rng(0)
    for stage in variables["batch_stats"]["encoder_decoder"].values():
        for conv in stage.values():
            n = conv["bn"]["mean"].shape[0]
            conv["bn"]["mean"] = rng.normal(0, 0.1, n).astype(np.float32)
            conv["bn"]["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    sd = state_dict_from_flax(variables, cfg)
    return (JaxEngine(jcfg, variables, threshold=THRESHOLD, bucket=256),
            GroundInferenceEngine(cfg, sd, threshold=THRESHOLD, bucket=256,
                                  device="cpu"))


def _labels_agree(pts, elev, lab_a, lab_b, tol):
    """Labels equal except for points within `tol` of the threshold."""
    diff = np.flatnonzero(lab_a != lab_b)
    ix = np.floor(pts[diff, 0] - SMALL["grid_range"][0]).astype(int)
    iy = np.floor(pts[diff, 1] - SMALL["grid_range"][1]).astype(int)
    margin = np.abs(pts[diff, 2] + 1.7 - elev.T[ix, iy] - THRESHOLD)
    assert (margin <= tol).all(), margin


@pytest.mark.parametrize("seed", [0, 1])
def test_engine_matches_jax_engine(engines, seed):
    jeng, teng = engines
    pts = scene(np.random.default_rng(seed))
    elev_j, lab_j = jeng.infer(pts)
    elev_t, lab_t = teng.infer(pts)
    assert elev_t.shape == (16, 16) and elev_t.dtype == np.float32
    assert lab_t.shape == (700,) and lab_t.dtype == np.int8
    np.testing.assert_allclose(elev_t, elev_j, rtol=1e-4, atol=1e-5)
    assert set(np.unique(lab_t)) <= {-1, 0, 1}
    assert (lab_t == 1).any() and (lab_t == 0).any() and (lab_t == -1).any()
    _labels_agree(pts, elev_j, lab_j, lab_t, tol=1e-4)


def test_engine_transfer_options_match_jax(engines):
    """int16 transfer, xyz-only scans (zero-filled feature) and bucket
    padding follow the JAX engine."""
    jeng, teng = engines
    jcfg, cfg = jeng.cfg, teng.cfg
    pts = scene(np.random.default_rng(3), n=300)
    sd = teng.model.state_dict()
    for kw in ({"transfer_dtype": "int16"}, {"transfer_features": 3}):
        j = JaxEngine(jcfg, jeng._variables, threshold=THRESHOLD,
                      bucket=256, **kw)
        t = GroundInferenceEngine(cfg, sd, threshold=THRESHOLD, bucket=256,
                                  device="cpu", **kw)
        np.testing.assert_array_equal(t._prepare(pts)[0], j._prepare(pts)[0])
        (ej, lj), (et, lt) = j.infer(pts), t.infer(pts)
        np.testing.assert_allclose(et, ej, rtol=1e-4, atol=1e-5)
        _labels_agree(pts, ej, lj, lt, tol=1e-4)
    elev, labels = teng.infer(pts[:, :3])
    assert elev.shape == (16, 16) and labels.shape == (300,)
    assert teng.warmup(n=300) > 0


def test_engine_reference_path_matches_kernel_path(engines):
    _, teng = engines
    padded, _ = teng._prepare(scene(np.random.default_rng(4)))
    e1, l1 = teng.run(torch.from_numpy(padded))
    e2, l2 = teng.run(torch.from_numpy(padded), reference=True)
    assert torch.equal(e1, e2) and torch.equal(l1, l2)


def test_segment_cloud_matches_jax():
    rng = np.random.default_rng(8)
    pts = rng.uniform(-2, 18, (500, 3)).astype(np.float32)
    pts[:, 1] -= 10
    pts[:20, :2] = np.array([0.5, -7.5], np.float32)   # row/col 0: excluded
    elev = rng.normal(0, 0.5, (16, 16)).astype(np.float32)
    want = np.asarray(jax_segment_cloud(jnp.asarray(pts), (0.0, -8.0),
                                        1.0, jnp.asarray(elev), 0.2))
    got = segment_cloud(torch.from_numpy(pts), (0.0, -8.0), 1.0,
                        torch.from_numpy(elev), 0.2)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:20] == -1).all()
