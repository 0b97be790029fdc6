"""The port's `ops/postproc.py` against `gndnet_tpu.ops.postproc` on the
same numpy inputs: segmentation with its mask, obstacle compaction, the
occupancy image, both heightmap variants, the generator's rgb labels, the
outlier mask and the frustum filter."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gndnet_tpu.ops import postproc as jpp
from gndnet_tpu_torch.ops import postproc as tpp

GRID = (0.0, -8.0, 16.0, 8.0)       # 16 x 16 cells of 1 m
CELL = 1.0
LIDAR_HEIGHT = 1.7
HM_RTOL = 1e-6                       # heightmap: of the largest |value|


def cloud(seed, n=3000):
    """Points in row and column 0, out of the grid on every side, with
    z + lidar_height >= 10, a 400-point cell past max_points=100, and
    empty cells."""
    rng = np.random.default_rng(seed)
    p = np.zeros((n, 3), np.float32)
    p[:, 0] = rng.uniform(-2.0, 18.0, n)
    p[:, 1] = rng.uniform(-10.0, 10.0, n)
    p[:, 2] = rng.uniform(-3.0, 2.0, n)
    p[:300, 0] = rng.uniform(0.0, 1.0, 300)          # row 0
    p[300:600, 1] = rng.uniform(-8.0, -7.0, 300)     # column 0
    p[600:800, 2] = rng.uniform(8.3, 12.0, 200)      # z + 1.7 >= 10 mostly
    p[800:1200, :2] = rng.uniform(5.1, 5.9, (400, 2))  # one crowded cell
    p[1200:, :2] = np.where(p[1200:, :2] > 6.0, p[1200:, :2] + 9.0,
                            p[1200:, :2])            # leaves cells empty
    return p


def elevation(seed):
    return np.random.default_rng(seed).uniform(-2.0, -1.0, (16, 16)
                                               ).astype(np.float32)


@pytest.mark.parametrize("threshold", [0.0, 0.08])
def test_segment_cloud_masked_matches_jax(threshold):
    p, e = cloud(0), elevation(0)
    lj, mj = jpp.segment_cloud_masked(jnp.asarray(p), GRID, CELL,
                                      jnp.asarray(e), threshold)
    lt, mt = tpp.segment_cloud_masked(torch.from_numpy(p), GRID, CELL,
                                      torch.from_numpy(e), threshold)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert set(np.unique(lt.numpy())) == {-1.0, 0.0, 1.0}


def test_compact_obstacles_matches_jax():
    p = cloud(1)
    mask = np.random.default_rng(1).random(p.shape[0]) < 0.3
    cj, nj = jpp.compact_obstacles(jnp.asarray(p), jnp.asarray(mask))
    ct, nt = tpp.compact_obstacles(torch.from_numpy(p),
                                   torch.from_numpy(mask))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert nt.shape == () and nt.dtype == torch.int32
    assert int(nt) == int(nj) == int(mask.sum())
    np.testing.assert_array_equal(ct[int(nt):].numpy(), 0.0)


@pytest.mark.parametrize("lidar_height", [0.0, LIDAR_HEIGHT])
def test_lidar_to_img_matches_jax(lidar_height):
    p = cloud(2)
    ij = jpp.lidar_to_img(jnp.asarray(p), GRID, CELL, fill=2.5,
                          lidar_height=lidar_height)
    it = tpp.lidar_to_img(torch.from_numpy(p), GRID, CELL, fill=2.5,
                          lidar_height=lidar_height)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    img = it.numpy()
    assert (img[0] == 0).all() and (img[:, 0] == 0).all()   # 0 < idx
    assert (img == 0).any() and (img == 2.5).any()


@pytest.mark.parametrize("reference_eval_bug", [False, True])
def test_lidar_to_heightmap_matches_jax(reference_eval_bug):
    p = cloud(3)
    hj, cj = jpp.lidar_to_heightmap(
        jnp.asarray(p), GRID, CELL, max_points=100,
        lidar_height=LIDAR_HEIGHT, reference_eval_bug=reference_eval_bug)
    ht, ct = tpp.lidar_to_heightmap(
        torch.from_numpy(p), GRID, CELL, max_points=100,
        lidar_height=LIDAR_HEIGHT, reference_eval_bug=reference_eval_bug)
    assert ct.dtype == torch.int32 and ht.dtype == torch.float32
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    hj = np.asarray(hj)
    np.testing.assert_allclose(ht.numpy(), hj, rtol=0,
                               atol=HM_RTOL * np.abs(hj).max())
    counts = ct.numpy()
    assert counts.max() == 100 and (counts == 0).any()
    # row and column 0 hold points: kept by the generator variant only
    assert (counts[0].sum() == 0) == reference_eval_bug


def test_lidar_to_heightmap_out_shape_matches_jax():
    p = cloud(4)
    hj, cj = jpp.lidar_to_heightmap(jnp.asarray(p), GRID, CELL,
                                    max_points=7, out_shape=(12, 20))
    ht, ct = tpp.lidar_to_heightmap(torch.from_numpy(p), GRID, CELL,
                                    max_points=7, out_shape=(12, 20))
    assert ht.shape == (12, 20)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=0,
                               atol=HM_RTOL * np.abs(np.asarray(hj)).max())


def test_semantically_segment_cloud_matches_jax_on_jnp_input():
    """JAX shifts z by lidar_height only for a jax array (what its
    generator passes); the port always shifts, and equals JAX there."""
    p, e = cloud(5), elevation(5)
    rj = jpp.semantically_segment_cloud(jnp.asarray(p), GRID, CELL,
                                        jnp.asarray(e), LIDAR_HEIGHT)
    rt = tpp.semantically_segment_cloud(torch.from_numpy(p), GRID, CELL,
                                        torch.from_numpy(e), LIDAR_HEIGHT)
    assert rt.shape == (p.shape[0], 3)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(rt[:, 1:].numpy(), 0.0)
    assert (rt[:, 0].numpy() == 1).any() and (rt[:, 0].numpy() == 0).any()


def test_remove_outliers_matches_jax():
    rng = np.random.default_rng(6)
    pred = rng.choice(np.array([-1, 0, 1], np.float32), 500)
    gt = rng.choice(np.array([-1, 0, 1], np.float32), 500)
    want = jpp.remove_outliers(jnp.asarray(pred), jnp.asarray(gt))
    got = tpp.remove_outliers(torch.from_numpy(pred), torch.from_numpy(gt))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_frustum_planes_match_jax():
    args = ([0.5, -0.2, 0.1], [1.0, 0.3, -0.1], 70.0, 0.2, 25.0, 1.5)
    oj, nj = jpp.frustum_planes(*args)
    ot, nt = tpp.frustum_planes(*args)
    assert ot.dtype == np.float64 and nt.shape == (6, 3)
    np.testing.assert_array_equal(ot, oj)
    np.testing.assert_array_equal(nt, nj)


@pytest.mark.parametrize("view", [
    ((0.0, 0.0, 0.0), (1.0, 0.0, 0.0), 115.0, 16 / 9, 0.1, 10.0),
    ((1.0, -2.0, 0.5), (0.6, 0.7, -0.1), 60.0, 1.0, 0.5, 14.0)],
    ids=["camera_fov", "oblique"])
def test_filter_points_by_frustum_matches_jax(view):
    p = cloud(7)
    mj = jpp.filter_points_by_frustum(jnp.asarray(p), *view)
    mt = tpp.filter_points_by_frustum(torch.from_numpy(p), *view)
    assert mt.dtype == torch.bool
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert 0 < int(mt.sum()) < p.shape[0]
