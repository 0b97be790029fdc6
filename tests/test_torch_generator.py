"""The port's `data/generator.py` and `StreamingLoader` against
`gndnet_tpu.data.generator` and `gndnet_tpu.data.provider` on
tests/test_data_pipeline.py's fake SemanticKITTI sequences, with seeded
rngs: parsing, the ground plane, one frame, a whole sequence's files,
block numbering, the spawn pool, the loader's batches, and the CLI."""

import dataclasses
import os

import numpy as np
import pytest
import yaml

from gndnet_tpu.config import AugmentationConfig as JaxAug
from gndnet_tpu.config import GndNetConfig as JaxConfig
from gndnet_tpu.data import augmentation as jaug
from gndnet_tpu.data import generator as jgen
from gndnet_tpu.data import provider as jprov
from gndnet_tpu_torch.config import AugmentationConfig, GndNetConfig
from gndnet_tpu_torch.data import augmentation as taug
from gndnet_tpu_torch.data import generator as tgen
from gndnet_tpu_torch.data import provider as tprov
from gndnet_tpu_torch.scripts import generate_data as gen_cli

# tests/test_data_pipeline.py's config
SMALL = dict(pc_range=(-8.0, -8.0, -4.0, 8.0, 8.0, 4.0),
             grid_range=(-8.0, -8.0, 8.0, 8.0), voxel_size=(1.0, 1.0, 8.0),
             max_points_voxel=20, max_voxels=256, input_features=4,
             num_points=2048, lidar_height=1.7)
JCFG, CFG = JaxConfig(**SMALL), GndNetConfig(**SMALL)
GRID_ATOL = 1e-6        # elevation grids: the heightmaps' summation order


def sloped_scene(rng, n=4000):
    """A sloped ground plane (class 40) and box obstacles (class 10)."""
    cloud = np.zeros((n, 4), np.float32)
    cloud[:, 0] = rng.uniform(-8, 8, n)
    cloud[:, 1] = rng.uniform(-8, 8, n)
    ground_z = 0.05 * cloud[:, 0] - CFG.lidar_height
    cloud[:, 2] = ground_z + rng.normal(0, 0.02, n)
    cloud[:, 3] = 40
    obst = rng.random(n) < 0.15
    cloud[obst, 2] = ground_z[obst] + rng.uniform(0.5, 2.0, obst.sum())
    cloud[obst, 3] = 10
    return cloud


def write_sequence(rng, seq_dir, n_frames, poison=None):
    """velodyne/*.bin + labels/*.label; frame `poison` lies far outside
    the grid, so it yields no ground."""
    (seq_dir / "velodyne").mkdir(parents=True)
    (seq_dir / "labels").mkdir()
    for i in range(n_frames):
        c = sloped_scene(rng)
        if i == poison:
            c = np.full((100, 4), 500.0, np.float32)
            c[:, 3] = 40
        xyzr = np.concatenate(
            [c[:, :3], np.zeros((len(c), 1), np.float32)], axis=1)
        xyzr.astype(np.float32).tofile(seq_dir / "velodyne" / f"{i:06d}.bin")
        c[:, 3].astype(np.uint32).tofile(seq_dir / "labels" / f"{i:06d}.label")


def assert_same_outputs(got_dir, want_dir, n):
    """Array-equal clouds; grids within GRID_ATOL."""
    for sub in ("reduced_velo", "gnd_labels"):
        assert sorted(os.listdir(got_dir / sub)) == \
            sorted(os.listdir(want_dir / sub)) == \
            [f"{i:06d}.npy" for i in range(n)]
    for i in range(n):
        f = f"{i:06d}.npy"
        np.testing.assert_array_equal(np.load(got_dir / "reduced_velo" / f),
                                      np.load(want_dir / "reduced_velo" / f))
        got = np.load(got_dir / "gnd_labels" / f)
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, np.load(want_dir / "gnd_labels" / f),
                                   rtol=0, atol=GRID_ATOL)


# --- parsing ----------------------------------------------------------------

def test_parse_calibration_poses_match_jax(tmp_path):
    calib = tmp_path / "calib.txt"
    calib.write_text("P0: 1 0 0 0 0 1 0 0 0 0 1 0\n"
                     "Tr: 0 -1 0 1 0 0 -1 2 1 0 0 3\n"
                     "comment line without a colon\n")
    poses = tmp_path / "poses.txt"
    poses.write_text("1 0 0 5 0 1 0 0 0 0 1 0\n"
                     "0 0 1 1 0 1 0 2 -1 0 0 3\n")
    cj, ct = jgen.parse_calibration(str(calib)), tgen.parse_calibration(
        str(calib))
    assert sorted(ct) == sorted(cj) == ["P0", "Tr"]
    for k in cj:
        np.testing.assert_array_equal(ct[k], cj[k])
    pj, pt = (jgen.parse_poses(str(poses), cj),
              tgen.parse_poses(str(poses), ct))
    assert len(pt) == len(pj) == 2
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(a, b)


def test_load_scan_and_split_ground_match_jax(tmp_path):
    write_sequence(np.random.default_rng(0), tmp_path / "seq", 1)
    paths = (str(tmp_path / "seq" / "velodyne" / "000000.bin"),
             str(tmp_path / "seq" / "labels" / "000000.label"))
    got, want = tgen.load_scan(*paths), jgen.load_scan(*paths)
    assert got.dtype == np.float32 and got.shape == (4000, 4)
    np.testing.assert_array_equal(got, want)
    for a, b in zip(tgen.split_ground(got), jgen.split_ground(want)):
        np.testing.assert_array_equal(a, b)
    c = np.array([[0, 0, 0, 40], [0, 0, 0, 10], [0, 0, 0, 72]], np.float32)
    g, o = tgen.split_ground(c)
    assert g.shape[0] == 2 and o.shape[0] == 1


# --- the ground plane -------------------------------------------------------

def test_compute_ground_plane_recovers_slope():
    cloud = sloped_scene(np.random.default_rng(1))
    _, grid = tgen.compute_ground_plane(cloud, CFG.grid_range, 1.0,
                                        CFG.lidar_height, device="cpu")
    assert grid.shape == (16, 16) and grid.dtype == np.float64
    xs = np.arange(16) + 0.5 - 8.0
    err = np.abs(grid - 0.05 * xs[:, None])
    assert np.median(err) < 0.1, np.median(err)


def test_compute_ground_plane_outlier_removal_matches_jax():
    """A spike of road-labelled points in one cell is smoothed back toward
    the plane by the outlier rounds, as in JAX."""
    cloud = sloped_scene(np.random.default_rng(2))
    spike = np.zeros((50, 4), np.float32)
    spike[:, :2] = 3.2
    spike[:, 2] = 5.0
    spike[:, 3] = 40
    cloud = np.concatenate([cloud, spike])
    gt, grid = tgen.compute_ground_plane(cloud, CFG.grid_range, 1.0,
                                         CFG.lidar_height, device="cpu")
    gj, want = jgen.compute_ground_plane(cloud, JCFG.grid_range, 1.0,
                                         JCFG.lidar_height)
    assert grid[11, 11] < 1.0
    np.testing.assert_array_equal(gt, gj)
    np.testing.assert_allclose(grid, want, rtol=0, atol=GRID_ATOL)


# --- one frame and a sequence -----------------------------------------------

AUG = dict(num_rotations=1, max_front_slope=3, max_side_tilt=3,
           max_rotation=20, num_height_var=1, max_height=0.3,
           num_noise_var=1, noise_coefficient_bottom=(0.4, 0.6),
           noise_density_bottom=(20, 40), noise_min_distance=(0.5, 1.0))


@pytest.mark.parametrize("augmented", [False, True])
def test_process_frame_matches_jax(augmented):
    """The reduced cloud array-equal and the grid within GRID_ATOL, with
    the same resampling rng and, when augmented, the same host pipeline
    draws (rotation, height, noise)."""
    cloud = sloped_scene(np.random.default_rng(3))
    aug_j = aug_t = None
    if augmented:
        aug_j = jaug.AugmentationPipeline(JaxAug(**AUG), JCFG.grid_range,
                                          JCFG.voxel_size,
                                          rng=np.random.default_rng(4))
        aug_t = taug.AugmentationPipeline(AugmentationConfig(**AUG),
                                          CFG.grid_range, CFG.voxel_size,
                                          rng=np.random.default_rng(4))
    want = jgen.process_frame(cloud.copy(), JCFG, aug_j,
                              rng=np.random.default_rng(5))
    got = tgen.process_frame(cloud.copy(), CFG, aug_t,
                             rng=np.random.default_rng(5), device="cpu")
    assert got.cloud.shape == (CFG.num_points, 4)
    assert got.cloud.dtype == np.float32 and got.elevation.dtype == np.float64
    assert set(np.unique(got.cloud[:, 3])) <= {-1.0, 0.0, 1.0}
    np.testing.assert_array_equal(got.cloud, want.cloud)
    np.testing.assert_allclose(got.elevation, want.elevation, rtol=0,
                               atol=GRID_ATOL)


def test_generate_sequence_matches_jax(tmp_path):
    """Compact mode with the camera field of view on, seeded per frame:
    the written files match JAX's; the pair round-trips through the port's
    training provider."""
    write_sequence(np.random.default_rng(6), tmp_path / "seq", 2)
    prep = dict(camera_fov=True, fov_far=12.0)
    jcfg = JCFG.replace(data_prep=dataclasses.replace(JCFG.data_prep,
                                                      **prep))
    cfg = CFG.replace(data_prep=dataclasses.replace(CFG.data_prep, **prep))
    assert jgen.generate_sequence(str(tmp_path / "seq"),
                                  str(tmp_path / "jax"), jcfg, seed=7) == 2
    assert tgen.generate_sequence(str(tmp_path / "seq"),
                                  str(tmp_path / "port"), cfg, seed=7,
                                  device="cpu") == 2
    assert_same_outputs(tmp_path / "port", tmp_path / "jax", 2)
    velo = np.load(tmp_path / "port" / "reduced_velo" / "000000.npy")
    assert velo[:, 0].min() >= 0.0           # in front of the camera

    root = tmp_path / "train_root" / "training" / "seq_000"
    root.mkdir(parents=True)
    os.symlink(tmp_path / "port" / "reduced_velo", root / "reduced_velo")
    os.symlink(tmp_path / "port" / "gnd_labels", root / "gnd_labels")
    ds = tprov.GroundDataset(str(tmp_path / "train_root"), "training",
                             num_input_features=4)
    batches = list(tprov.iterate_batches(ds, 2, drop_last=True))
    assert batches[0][0].shape == (2, CFG.num_points, 4)
    assert batches[0][1].shape == (2, 16, 16)


def test_block_positional_numbering_with_skips(tmp_path):
    """Block mode writes positional names; the compactor renumbers the
    union to the serial 0..n-1 when a middle frame is skipped; and
    `generate_dataset` with 1 worker and 2-frame blocks writes what the
    serial run writes."""
    seq = tmp_path / "data" / "sequences" / "01"
    write_sequence(np.random.default_rng(7), seq, 3, poison=1)
    out = tmp_path / "out"
    p0 = tgen.generate_sequence(str(seq), str(out), CFG, start=0, count=2,
                                index_base=0, seed=3, device="cpu")
    p1 = tgen.generate_sequence(str(seq), str(out), CFG, start=2, count=1,
                                index_base=2, seed=3, device="cpu")
    assert p0 == [0] and p1 == [2]
    assert tgen.compact_positional_outputs(str(out), p0 + p1) == 2
    assert sorted(os.listdir(out / "reduced_velo")) == \
        ["000000.npy", "000001.npy"]

    serial = tmp_path / "serial"
    assert tgen.generate_sequence(str(seq), str(serial), CFG, seed=3,
                                  device="cpu") == 2
    cfg = CFG.replace(data_prep=dataclasses.replace(
        CFG.data_prep, frames_per_block=2, num_workers=1))
    assert tgen.generate_dataset(str(tmp_path / "data"),
                                 str(tmp_path / "blocked"), cfg, seed=3,
                                 device="cpu") == 2
    assert_same_outputs(tmp_path / "blocked" / "sequences" / "01", serial, 2)


@pytest.mark.slow
def test_block_split_matches_serial(tmp_path):
    """Two 2-frame blocks over a 2-worker spawn pool, each worker on the
    device it is given, write the serial run's files (marked slow as
    tests/test_data_pipeline.py's counterpart is)."""
    write_sequence(np.random.default_rng(8), tmp_path / "sequences" / "00", 4)
    serial = tmp_path / "serial"
    assert tgen.generate_sequence(str(tmp_path / "sequences" / "00"),
                                  str(serial), CFG, seed=7,
                                  device="cpu") == 4
    cfg = CFG.replace(data_prep=dataclasses.replace(
        CFG.data_prep, frame_step=1, frames_per_block=2, num_workers=2))
    assert tgen.generate_dataset(str(tmp_path), str(tmp_path / "blocked"),
                                 cfg, seed=7, device="cpu") == 4
    assert_same_outputs(tmp_path / "blocked" / "sequences" / "00", serial, 4)


# --- the streaming loader ---------------------------------------------------

@pytest.mark.parametrize("drop_last", [True, False])
def test_streaming_loader_matches_jax(tmp_path, drop_last):
    root = tmp_path / "training" / "seq_000"
    (root / "reduced_velo").mkdir(parents=True)
    (root / "gnd_labels").mkdir()
    rng = np.random.default_rng(9)
    for i in range(7):
        np.save(root / "reduced_velo" / f"{i:06d}.npy",
                rng.random((128, 4)).astype(np.float32))
        np.save(root / "gnd_labels" / f"{i:06d}.npy", rng.random((8, 8)))
    kw = dict(batch_size=2, num_input_features=3, seed=5,
              drop_last=drop_last)
    jl = jprov.StreamingLoader(str(tmp_path), "training", **kw)
    tl = tprov.StreamingLoader(str(tmp_path), "training", **kw)
    assert len(tl) == len(jl) == (3 if drop_last else 4)
    for epoch in (0, 1):
        got, want = list(tl.epoch(epoch)), list(jl.epoch(epoch))
        assert len(got) == len(want) == len(tl)
        for (gc, gl), (wc, wl) in zip(got, want):
            assert gc.dtype == gl.dtype == np.float32
            np.testing.assert_array_equal(gc, wc)
            np.testing.assert_array_equal(gl, wl)
    assert got[-1][0].shape == ((2, 128, 3) if drop_last else (1, 128, 3))
    a, b = (next(iter(tl.epoch(e)))[0] for e in (0, 1))
    assert not np.array_equal(a, b)
    staged = list(tprov.prefetch_to_device(tl.epoch(0), "cpu"))
    np.testing.assert_array_equal(staged[0][0].numpy(),
                                  next(iter(tl.epoch(0)))[0])


def test_streaming_loader_stops_its_thread_when_abandoned(tmp_path):
    """A consumer that takes one batch and closes the epoch while the
    reader waits on a full queue stops the reader."""
    import threading

    root = tmp_path / "training" / "seq_000"
    (root / "reduced_velo").mkdir(parents=True)
    (root / "gnd_labels").mkdir()
    for i in range(12):
        np.save(root / "reduced_velo" / f"{i:06d}.npy",
                np.zeros((16, 4), np.float32))
        np.save(root / "gnd_labels" / f"{i:06d}.npy", np.zeros((4, 4)))
    loader = tprov.StreamingLoader(str(tmp_path), "training", batch_size=1,
                                   queue_depth=2)
    it = loader.epoch(0)
    next(it)
    readers = [t for t in threading.enumerate()
               if t.name == "StreamingLoader"]
    assert len(readers) == 1
    readers[0].join(0.5)
    assert readers[0].is_alive()          # blocked on the full queue
    it.close()
    readers[0].join(5.0)
    assert not readers[0].is_alive()


# --- the CLI ----------------------------------------------------------------

def test_generate_data_cli(tmp_path, monkeypatch):
    """`python -m gndnet_tpu_torch.scripts.generate_data` writes what
    `generate_dataset` writes."""
    write_sequence(np.random.default_rng(10), tmp_path / "raw" / "sequences"
                   / "00", 2)
    cfg_path = tmp_path / "small.yaml"
    cfg_path.write_text(yaml.safe_dump(
        {k: list(v) if isinstance(v, tuple) else v
         for k, v in SMALL.items()}))      # the reference's flat layout
    monkeypatch.chdir(tmp_path)       # the CLI logs to ./dataprep.log
    gen_cli.main(["--config", str(cfg_path), "--data_dir",
                  str(tmp_path / "raw"), "--out_dir", str(tmp_path / "cli"),
                  "--num_workers", "1", "--device", "cpu"])
    assert (tmp_path / "dataprep.log").exists()
    cfg = CFG.replace(data_prep=dataclasses.replace(CFG.data_prep,
                                                    num_workers=1))
    assert tgen.generate_dataset(str(tmp_path / "raw"),
                                 str(tmp_path / "api"), cfg,
                                 device="cpu") == 2
    assert_same_outputs(tmp_path / "cli" / "sequences" / "00",
                        tmp_path / "api" / "sequences" / "00", 2)
