"""The port's host modules against the JAX package's own: `native` (its own
copy of the C++ host library, built into gndnet_tpu_torch/_build/),
`io_shim` and `ops/transforms`, on the same inputs, array_equal."""

import threading

import numpy as np
import pytest

from gndnet_tpu import io_shim as jio
from gndnet_tpu import native as jnative
from gndnet_tpu.config import GndNetConfig as JaxConfig
from gndnet_tpu.ops import transforms as jtf
from gndnet_tpu_torch import io_shim as tio
from gndnet_tpu_torch import native as tnative
from gndnet_tpu_torch.config import GndNetConfig
from gndnet_tpu_torch.ops import transforms as ttf
from oracles import segment_cloud_oracle, voxelize_oracle

VOXEL = (1.0, 1.0, 8.0)
RANGE = (0.0, 0.0, -4.0, 8.0, 8.0, 4.0)


@pytest.fixture(scope="module")
def both():
    """The port's library and the JAX package's, or a skip where g++
    cannot build them."""
    if not tnative.available() or not jnative.available():
        pytest.skip("native toolchain unavailable")
    return jnative, tnative


def cloud(rng, n=800):
    pts = rng.uniform(size=(n, 4)).astype(np.float32)
    pts[:, 0] = pts[:, 0] * 10 - 1
    pts[:, 1] = pts[:, 1] * 10 - 1
    pts[:, 2] = pts[:, 2] * 10 - 5
    return pts


def test_library_builds_into_the_port(both):
    _, t = both
    path = t._lib_path()
    assert path.startswith(t.BUILD_DIR) and path.endswith(".so")
    assert "gndnet_tpu_torch" in path


@pytest.mark.parametrize("max_points,max_voxels,brk", [
    (5, 64, True), (5, 8, True), (3, 8, False), (10, 128, True)])
def test_voxelize_matches_jax_native(both, max_points, max_voxels, brk):
    j, t = both
    pts = cloud(np.random.default_rng(max_points * max_voxels))
    got = t.voxelize(pts, VOXEL, RANGE, max_points, max_voxels,
                     reference_break=brk)
    want = j.voxelize(pts, VOXEL, RANGE, max_points, max_voxels,
                      reference_break=brk)
    oracle = voxelize_oracle(pts, VOXEL, RANGE, max_points, max_voxels,
                             reference_break=brk)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[1], oracle[1])
    np.testing.assert_array_equal(got[2], oracle[2])


def test_segment_cloud_host_matches_jax_native(both):
    j, t = both
    rng = np.random.default_rng(3)
    pts = cloud(rng, 300)[:, :3]
    elev = rng.normal(0, 0.5, (8, 8)).astype(np.float32)
    got = t.segment_cloud_host(pts, (0.0, 0.0, 8.0, 8.0), 1.0, elev, 0.2)
    want = j.segment_cloud_host(pts, (0.0, 0.0, 8.0, 8.0), 1.0, elev, 0.2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, segment_cloud_oracle(
        pts.astype(np.float64), (0.0, 0.0, 8.0, 8.0), 1.0, elev, 0.2))


def test_shift_and_transform_match_jax_native(both):
    j, t = both
    pts = cloud(np.random.default_rng(4), 50)
    a, b = pts.copy(), pts.copy()
    np.testing.assert_array_equal(t.shift_cloud_host(a, 1.5),
                                  j.shift_cloud_host(b, 1.5))
    m = ttf.transformation_matrix(
        [1.0, -2.0, 0.5],
        ttf.quaternion_rotation_matrix(ttf.quaternion_from_euler(0.2, -0.1,
                                                                 0.7)))
    a, b = pts.copy(), pts.copy()
    np.testing.assert_array_equal(t.transform_cloud_host(a, m),
                                  j.transform_cloud_host(b, m))
    np.testing.assert_allclose(a[:, :3], pts[:, :3] @ m[:3, :3].T + m[:3, 3],
                               atol=1e-5)
    with pytest.raises(ValueError, match="float32"):
        t.shift_cloud_host(pts.astype(np.float64), 1.0)


def test_mailbox_basic(both):
    _, t = both
    mb = t.NativeMailbox(1024)
    out = np.zeros(1024, np.uint8)
    assert mb.read_latest(out)[0] == 0
    payload = np.arange(100, dtype=np.float32)
    s1 = mb.write(payload)
    n, seq = mb.read_latest(out)
    assert n == 400 and seq == s1
    np.testing.assert_array_equal(out[:400].view(np.float32), payload)
    assert mb.read_latest(out)[0] == 0          # nothing new
    mb.write(payload)                           # drop-old: only the newest
    s3 = mb.write(payload * 2)
    n, seq = mb.read_latest(out)
    assert seq == s3
    np.testing.assert_array_equal(out[:400].view(np.float32), payload * 2)
    with pytest.raises(ValueError, match="exceeds capacity"):
        mb.write(np.zeros(2048, np.uint8))
    mb.close()
    mb.close()                                  # idempotent


def test_mailbox_concurrent_stress(both):
    """Writer floods, reader samples: every read is internally consistent
    (all elements equal its value) and values strictly increase."""
    _, t = both
    mb = t.NativeMailbox(4096)
    n_msgs = 20000
    errors, seen = [], []

    def reader():
        out = np.zeros(4096, np.uint8)
        last = 0
        while last < n_msgs:
            n, seq = mb.read_latest(out)
            if n == 0:
                continue
            vals = out[:n].view(np.int32)
            if not np.all(vals == vals[0]):
                errors.append(("torn read", seq))
                return
            if vals[0] <= last and seen:
                errors.append(("non-monotonic", vals[0], last))
                return
            last = int(vals[0])
            seen.append(last)

    th = threading.Thread(target=reader)
    th.start()
    for i in range(1, n_msgs + 1):
        mb.write(np.full(1024, i, np.int32))
    th.join(timeout=30)
    assert not th.is_alive()
    assert not errors, errors[:3]
    assert seen[-1] == n_msgs
    assert all(b > a for a, b in zip(seen, seen[1:]))
    mb.close()


# ---------------------------------------------------------------------------
# io_shim and transforms (numpy only)
# ---------------------------------------------------------------------------

def test_pointcloud2_roundtrip_matches_jax():
    rng = np.random.default_rng(5)
    xyz = rng.normal(0, 10, (64, 3)).astype(np.float32)
    inten = rng.uniform(0, 1, 64).astype(np.float32)
    labels = rng.integers(-1, 2, 64)
    for kw in ({}, {"intensity": inten}, {"rgb_labels": labels},
               {"intensity": inten, "rgb_labels": labels}):
        got, want = tio.numpy_to_pointcloud2(xyz, **kw), \
            jio.numpy_to_pointcloud2(xyz, **kw)
        assert got["data"] == want["data"]
        assert [(f.name, f.offset, f.datatype) for f in got["fields"]] == \
            [(f.name, f.offset, f.datatype) for f in want["fields"]]
        assert (got["point_step"], got["width"], got["height"]) == \
            (want["point_step"], want["width"], want["height"])
        dec_t = tio.pointcloud2_to_numpy(got["data"], got["point_step"],
                                         got["fields"])
        dec_j = jio.pointcloud2_to_numpy(want["data"], want["point_step"],
                                         want["fields"])
        assert dec_t.keys() == dec_j.keys()
        for k in dec_t:
            np.testing.assert_array_equal(dec_t[k], dec_j[k])
        np.testing.assert_array_equal(dec_t["xyz"], xyz)


def test_cloud_helpers_match_jax():
    rng = np.random.default_rng(6)
    pts = rng.normal(0, 20, (2000, 4)).astype(np.float32)
    pts[:, 2] = rng.uniform(-3, 3, 2000)
    np.testing.assert_array_equal(tio.shift_cloud(pts.copy(), 1.7),
                                  jio.shift_cloud(pts.copy(), 1.7))
    box = (-10.0, -5.0, 12.0, 5.0)
    np.testing.assert_array_equal(tio.crop_cloud(pts, box),
                                  jio.crop_cloud(pts, box))
    np.testing.assert_array_equal(
        tio.random_sample(pts, 300, np.random.default_rng(1)),
        jio.random_sample(pts, 300, np.random.default_rng(1)))
    np.testing.assert_array_equal(tio.random_sample(pts[:1], 5),
                                  jio.random_sample(pts[:1], 5))
    for keep, phase in ((2, 0), (2, 1), (4, 3)):
        np.testing.assert_array_equal(
            tio.subsample_beams(pts, 64, keep, phase),
            jio.subsample_beams(pts, 64, keep, phase))


@pytest.mark.parametrize("decimate", [1, 4, 7])
def test_elevation_grid_lines_match_jax(decimate):
    kw = dict(pc_range=(0.0, -8.0, -4.0, 16.0, 8.0, 4.0),
              grid_range=(0.0, -8.0, 16.0, 8.0), voxel_size=(1.0, 1.0, 8.0))
    elev = np.random.default_rng(7).normal(0, 1, (16, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        tio.elevation_grid_lines(elev, GndNetConfig(**kw), decimate),
        jio.elevation_grid_lines(elev, JaxConfig(**kw), decimate))


def test_transforms_match_jax():
    rng = np.random.default_rng(8)
    pts = rng.normal(0, 10, (500, 4)).astype(np.float32)
    for roll, pitch, yaw in rng.uniform(-3, 3, (5, 3)):
        q_t = ttf.quaternion_from_euler(roll, pitch, yaw)
        np.testing.assert_array_equal(
            q_t, jtf.quaternion_from_euler(roll, pitch, yaw))
        assert ttf.euler_from_quaternion(*q_t) == \
            jtf.euler_from_quaternion(*q_t)
        r = ttf.quaternion_rotation_matrix(q_t)
        np.testing.assert_array_equal(r, jtf.quaternion_rotation_matrix(q_t))
        t = rng.normal(0, 5, 3)
        m = ttf.transform_from_translation_quaternion(t, q_t)
        np.testing.assert_array_equal(
            m, jtf.transform_from_translation_quaternion(t, q_t))
        np.testing.assert_array_equal(m, ttf.transformation_matrix(t, r))
        np.testing.assert_array_equal(ttf.transform_cloud(pts, m),
                                      jtf.transform_cloud(pts, m))
        angles = np.degrees([yaw, pitch, roll])
        np.testing.assert_array_equal(
            ttf.rotate_cloud_euler_zyx(pts, angles),
            jtf.rotate_cloud_euler_zyx(pts, angles))
