"""The port's `data/augmentation.py` against `gndnet_tpu.data.augmentation`:
the host pipeline array-equal for the same seed, the device transform
given JAX's own draws, the co-rotated label grid under the port's draws,
and draws reproducible from (seed, step)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gndnet_tpu.config import AugmentationConfig as JaxAug
from gndnet_tpu.config import GndNetConfig as JaxConfig
from gndnet_tpu.data import augmentation as jaug
from gndnet_tpu_torch.config import AugmentationConfig, GndNetConfig
from gndnet_tpu_torch.data import augmentation as taug

GRID = dict(pc_range=(-8.0, -8.0, -4.0, 8.0, 8.0, 4.0),
            grid_range=(-8.0, -8.0, 8.0, 8.0), voxel_size=(1.0, 1.0, 8.0),
            max_points_voxel=20, max_voxels=256, input_features=4,
            num_points=2048, lidar_height=1.7)
DEVICE_ATOL = 1e-5      # device transform vs JAX: of the largest |value|


def pipelines(seed, **aug):
    """The JAX and the port pipeline, each with default_rng(seed)."""
    return (jaug.AugmentationPipeline(JaxAug(**aug), GRID["grid_range"],
                                      GRID["voxel_size"],
                                      rng=np.random.default_rng(seed)),
            taug.AugmentationPipeline(AugmentationConfig(**aug),
                                      GRID["grid_range"], GRID["voxel_size"],
                                      rng=np.random.default_rng(seed)))


def sloped_scene(rng, n=4000):
    """tests/test_data_pipeline.py's labelled scene: a sloped ground plane
    (class 40) and box obstacles (class 10)."""
    cloud = np.zeros((n, 4), np.float32)
    cloud[:, 0] = rng.uniform(-8, 8, n)
    cloud[:, 1] = rng.uniform(-8, 8, n)
    ground_z = 0.05 * cloud[:, 0] - GRID["lidar_height"]
    cloud[:, 2] = ground_z + rng.normal(0, 0.02, n)
    cloud[:, 3] = 40
    obst = rng.random(n) < 0.15
    cloud[obst, 2] = ground_z[obst] + rng.uniform(0.5, 2.0, obst.sum())
    cloud[obst, 3] = 10
    return cloud


# --- host pipeline ----------------------------------------------------------

def test_rotation_matches_jax():
    j, t = pipelines(0, num_rotations=1, max_front_slope=5, max_side_tilt=5,
                     max_rotation=180)
    data = np.random.default_rng(1).normal(size=(3, 100, 4))
    np.testing.assert_array_equal(t.augment_rotation(data.copy()),
                                  j.augment_rotation(data.copy()))


def test_rotation_with_gt_matches_jax():
    j, t = pipelines(2, num_rotations=1, max_front_slope=5, max_side_tilt=5,
                     max_rotation=30)
    rng = np.random.default_rng(3)
    data = rng.normal(size=(2, 500, 4)) * 5
    labels = rng.normal(-1.7, 0.2, (2, 16, 16))
    dj, lj = j.augment_rotation_with_gt(data.copy(), labels.copy())
    dt, lt = t.augment_rotation_with_gt(data.copy(), labels.copy())
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(lt, lj)
    assert not np.array_equal(lt, labels)


def test_height_matches_jax():
    j, t = pipelines(4, num_height_var=1, max_height=2.0)
    data = np.zeros((2, 50, 4))
    labels = np.zeros((2, 8, 8))
    dj, lj = j.augment_height(data.copy(), labels.copy())
    dt, lt = t.augment_height(data.copy(), labels.copy())
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(lt, lj)
    np.testing.assert_allclose(lt[1], dt[1, 0, 2])


@pytest.mark.parametrize("with_labels", [False, True])
def test_augment_batch_matches_jax(with_labels):
    j, t = pipelines(5, keep_original=True, num_rotations=2,
                     num_height_var=2, max_front_slope=5, max_height=0.5)
    rng = np.random.default_rng(6)
    data = rng.normal(size=(3, 64, 4))
    labels = rng.normal(size=(3, 8, 8)) if with_labels else None
    args = (data.copy(),) + ((labels.copy(),) if with_labels else ())
    want = j.augment_batch(*args)
    args = (data.copy(),) + ((labels.copy(),) if with_labels else ())
    got = t.augment_batch(*args)
    for g, w in zip(got if with_labels else (got,),
                    want if with_labels else (want,)):
        assert g.shape[0] == 3 + 3 * 2 * 2
        np.testing.assert_array_equal(g, w)


def test_noise_matches_jax():
    aug = dict(num_noise_var=1, noise_coefficient_top=(0.1, 0.2),
               noise_density_top=(100, 200),
               noise_coefficient_bottom=(0.4, 0.6),
               noise_density_bottom=(200, 400),
               noise_min_distance=(0.5, 1.0))
    j, t = pipelines(7, **aug)
    cloud = sloped_scene(np.random.default_rng(8))
    plane = np.zeros((16, 16)) - GRID["lidar_height"]
    want = j.add_noise(cloud.copy(), plane)
    got = t.add_noise(cloud.copy(), plane)
    np.testing.assert_array_equal(got, want)
    added = got[got[:, 3] == taug.NOISE_CLASS]
    assert taug.NOISE_CLASS == jaug.NOISE_CLASS == 260
    assert added.shape[0] > 0 and got.shape[0] == cloud.shape[0] + len(added)


def test_camera_fov_matches_jax():
    j, t = pipelines(9)
    cloud = sloped_scene(np.random.default_rng(10))
    for args in ((), (90.0, 4 / 3, 0.5, 6.0)):
        want = j.camera_fov(cloud, *args)
        got = t.camera_fov(cloud, *args)
        np.testing.assert_array_equal(got, want)
        assert 0 < got.shape[0] < cloud.shape[0]


# --- on the device ----------------------------------------------------------

def device_cfgs(**aug):
    return (JaxConfig(**GRID, augmentation=JaxAug(**aug)),
            GndNetConfig(**GRID, augmentation=AugmentationConfig(**aug)))


def jax_draws(key, b, cfg):
    """The angles and height shifts `device_augment` draws from `key`."""
    a = cfg.augmentation
    k_rot, k_h = jax.random.split(key)
    lim = jnp.asarray([a.max_rotation, a.max_side_tilt,
                       a.max_front_slope]) * (jnp.pi / 180.0)
    ang = jax.random.uniform(k_rot, (b, 3), minval=-1.0, maxval=1.0) * lim
    dz = jax.random.uniform(k_h, (b,), minval=-1.0, maxval=1.0) * a.max_height
    return np.asarray(ang), np.asarray(dz)


@pytest.mark.parametrize("seed,hw", [(0, (16, 16)), (5, (12, 20))],
                         ids=["square", "wide"])
def test_apply_augment_matches_jax_device_augment(seed, hw):
    """The port's transform, given JAX's draws, against JAX's
    `device_augment`; a non-square grid pins sx to the width, sy to the
    height."""
    jcfg, cfg = device_cfgs(max_front_slope=5, max_side_tilt=5,
                            max_rotation=30, max_height=1.0)
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-8, 8, (3, 700, 4)).astype(np.float32)
    labels = rng.normal(-1.7, 0.3, (3,) + hw).astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(0), seed)
    pj, lj = jaug.device_augment(jnp.asarray(pts), jnp.asarray(labels), key,
                                 jcfg)
    ang, dz = jax_draws(key, 3, jcfg)
    rots = taug.euler_zyx_matrices(torch.tensor(ang))
    pt, lt = taug.apply_augment(torch.from_numpy(pts),
                                torch.from_numpy(labels), rots,
                                torch.tensor(dz), cfg)
    pj, lj = np.asarray(pj), np.asarray(lj)
    np.testing.assert_allclose(pt.numpy(), pj, rtol=0,
                               atol=DEVICE_ATOL * np.abs(pj).max())
    np.testing.assert_allclose(lt.numpy(), lj, rtol=0,
                               atol=DEVICE_ATOL * np.abs(lj).max())
    np.testing.assert_array_equal(pt[..., 3].numpy(), pts[..., 3])


def test_euler_matrices_match_scipy():
    """Rz @ Ry @ Rx as JAX's device path composes it: scipy's intrinsic
    'ZYX', not the host pipeline's extrinsic 'zyx' (Rx @ Ry @ Rz)."""
    from scipy.spatial.transform import Rotation

    ang = np.random.default_rng(12).uniform(-1, 1, (5, 3)).astype(np.float32)
    got = taug.euler_zyx_matrices(torch.from_numpy(ang)).numpy()
    want = Rotation.from_euler("ZYX", ang.astype(np.float64)).as_matrix()
    np.testing.assert_allclose(got, want, atol=1e-6)
    extrinsic = Rotation.from_euler("zyx", ang.astype(np.float64))
    assert np.abs(got - extrinsic.as_matrix()).max() > 0.1


def test_device_augment_keeps_ground_on_grid():
    """tests/test_data_pipeline.py:143-163 with the port's own draws:
    ground points stay on the co-rotated label grid."""
    _, cfg = device_cfgs(num_rotations=1, max_front_slope=5,
                         max_side_tilt=5, max_rotation=30, max_height=1.0)
    rng = np.random.default_rng(1234)
    n = 2000
    pts = np.zeros((2, n, 4), np.float32)
    pts[..., 0] = rng.uniform(-7, 7, (2, n))
    pts[..., 1] = rng.uniform(-7, 7, (2, n))
    pts[..., 2] = -1.0
    labels = np.full((2, 16, 16), -1.0, np.float32)
    gen = taug.augment_generator(0, 3, "cpu")
    out, lab = taug.device_augment(torch.from_numpy(pts),
                                   torch.from_numpy(labels), gen, cfg)
    out, lab = out.numpy(), lab.numpy()
    ix = np.clip(((out[..., 0] + 8) // 1).astype(int), 0, 15)
    iy = np.clip(((out[..., 1] + 8) // 1).astype(int), 0, 15)
    for b in range(2):
        d = np.abs(out[b, :, 2] - lab[b][iy[b], ix[b]])
        assert np.median(d) < 0.15, np.median(d)
    assert not np.allclose(out[..., 2], -1.0)     # it did move


def test_draws_reproducible_from_seed_and_step():
    _, cfg = device_cfgs(max_front_slope=5, max_side_tilt=5,
                         max_rotation=30, max_height=1.0)

    def draws(seed, step):
        return taug.augment_draws(taug.augment_generator(seed, step, "cpu"),
                                  4, cfg)

    a, b = draws(0, 7), draws(0, 7)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    for other in (draws(0, 8), draws(1, 7)):
        assert not torch.equal(a[0], other[0])
    ang, dz = a
    lim = torch.tensor([30.0, 5.0, 5.0]) * np.pi / 180
    assert ang.shape == (4, 3) and dz.shape == (4,)
    assert bool((ang.abs() <= lim).all()) and bool((dz.abs() <= 1.0).all())
