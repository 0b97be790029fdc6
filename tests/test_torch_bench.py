"""`gndnet_tpu_torch.bench` on the CPU against the JAX package's `bench.py`.

Tolerances: the host helpers (`load_scan`, `load_fixture_frames`,
`transfer_budget`) and the device ring and its bump are exact; the
device-mode anchor equals the per-slot sums taken one scan at a time;
`bench_accuracy`'s untrained figures (`rmse_before`, `iou_before`,
`first_loss`) agree with JAX's within 1e-5 relative, and after one step
(`rmse_after`, `final_loss`) within 2e-2 relative, the per-step train
tolerance of the port's train tests."""

import dataclasses
import json
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from gndnet_tpu import train as jtrain
from gndnet_tpu.config import kitti_sem_config as jax_kitti_sem
from gndnet_tpu.config import load_config as jax_load_config
from gndnet_tpu.infer import GroundInferenceEngine as JaxEngine
from gndnet_tpu_torch import _ext
from gndnet_tpu_torch import bench as tbench
from gndnet_tpu_torch import train as ttrain
from gndnet_tpu_torch.config import GndNetConfig
from gndnet_tpu_torch.config import kitti_sem_config, load_config
from gndnet_tpu_torch.infer import GroundInferenceEngine
from gndnet_tpu_torch.weights import init_state_dict, state_dict_from_flax

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import bench as jbench  # noqa: E402

SMALL = dict(pc_range=(0.0, -8.0, -4.0, 16.0, 8.0, 4.0),
             grid_range=(0.0, -8.0, 16.0, 8.0), voxel_size=(1.0, 1.0, 8.0),
             max_points_voxel=20, max_voxels=256, num_points=600,
             fused_impl="affine")
# bench.py's keys of each mode's line, without perf_accounting's fields,
# which a CPU line does not carry (bench.py:596-666)
BASE_KEYS = {"metric", "value", "unit", "vs_baseline", "mode", "config",
             "impl"}
BUDGET = {"bytes_up_per_scan", "bytes_down_per_scan",
          "relay_bytes_ceiling_hz"}
MODE_KEYS = {
    "device": {"note"},
    "e2e": BUDGET, "single": BUDGET,
    "batched": set(),
    "train": {"note"},
    "replay": {"paced", "freewheel", "note"},
    "stream": {"freewheel", "paced", "target_hz", "transfer",
               "transfer_features", "note"} | BUDGET,
}
PERF_FIELDS = {"gflops_per_scan", "achieved_tflops", "mfu_pct",
               "min_bytes_per_scan", "achieved_gbps", "hbm_pct", "batch",
               "chip", "peak_tflops_bf16", "peak_hbm_gbps"}


@pytest.fixture(autouse=True)
def no_fixture(monkeypatch):
    """The reference fixture is absent on both sides."""
    monkeypatch.delenv(tbench.REFERENCE_ENV, raising=False)


def small_cfg(**kw) -> GndNetConfig:
    return GndNetConfig(**{**SMALL, **kw})


# --- host helpers -------------------------------------------------------------

@pytest.mark.parametrize("name", ["kitti_sem", "camera", "sparse_32beam"])
def test_load_scan_matches_jax(name):
    want = jbench.load_scan(jax_load_config(name))
    got = tbench.load_scan(load_config(name))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tbench.load_scan(load_config(name), sparse_beams=True),
        jbench.load_scan(jax_load_config(name), sparse_beams=True))


def test_load_fixture_frames_none_on_both_sides():
    assert jbench.load_fixture_frames(jax_kitti_sem()) is None
    assert tbench.load_fixture_frames(kitti_sem_config()) is None


def test_fixture_frames_read_from_the_reference_checkout(tmp_path,
                                                         monkeypatch):
    """With GNDNET_REFERENCE_DIR set, the 5 frames are read and subsampled
    as bench.py reads them: np.random.default_rng(seed).choice a frame."""
    root = tmp_path / "data" / "training" / "seq_000"
    (root / "reduced_velo").mkdir(parents=True)
    (root / "gnd_labels").mkdir()
    rng = np.random.default_rng(3)
    clouds = rng.normal(size=(5, 50, 4))
    labels = rng.normal(size=(5, 100, 100))
    for i in range(5):
        np.save(root / "reduced_velo" / f"{i:06d}.npy", clouds[i])
        np.save(root / "gnd_labels" / f"{i:06d}.npy", labels[i])
    monkeypatch.setenv(tbench.REFERENCE_ENV, str(tmp_path))
    cfg = kitti_sem_config().replace(input_features=3)
    got_c, got_l = tbench.load_fixture_frames(cfg, num_points=20, seed=1)
    pick = np.random.default_rng(1)
    want = [clouds[i][pick.choice(50, 20, replace=False)][:, :3]
            for i in range(5)]
    np.testing.assert_array_equal(got_c, np.float32(want))
    np.testing.assert_array_equal(got_l, np.float32(labels))
    np.testing.assert_array_equal(tbench.load_scan(cfg),
                                  np.float32(clouds[0][:, :3]))


@pytest.mark.parametrize("transfer", [("float32", None), ("int16", None),
                                      ("float32", 3)],
                         ids=["float32", "int16", "features3"])
def test_transfer_budget_matches_jax(transfer):
    dtype, features = transfer
    cfg, jcfg = kitti_sem_config(), jax_kitti_sem()
    engine = GroundInferenceEngine(cfg, init_state_dict(cfg, seed=0),
                                   transfer_dtype=dtype,
                                   transfer_features=features, device="cpu")
    jengine = JaxEngine(jcfg, None, transfer_dtype=dtype,
                        transfer_features=features)
    for n in (100_000, 4096, 5000):
        assert (tbench.transfer_budget(engine, cfg, n)
                == jbench.transfer_budget(jengine, jcfg, n))


# --- device mode --------------------------------------------------------------

def _engine(cfg, seed=0, **kw):
    return GroundInferenceEngine(cfg, init_state_dict(cfg, seed=seed),
                                 threshold=0.08, shift_cloud=True,
                                 device="cpu", **kw)


def test_device_ring_and_bump_match_jax():
    """bench.py's make_ring (bench.py:88-93) and bump (:107), written out
    in jnp, against the port's on a prepared small scan, ring_size=4."""
    cfg = small_cfg()
    base, _ = _engine(cfg)._prepare(tbench.load_scan(cfg))
    jit_z = (jnp.arange(4, dtype=jnp.float32) * 1e-4)[:, None, None]
    want = jnp.asarray(base)[None] + jit_z * jnp.asarray(
        [0, 0, 1, 0], jnp.float32)[: base.shape[-1]]
    ring = tbench.make_ring(torch.from_numpy(base), 4)
    np.testing.assert_array_equal(ring.numpy(), np.asarray(want))
    for _ in range(2):
        want = want.at[..., 2].add(jnp.bfloat16(1e-6).astype(want.dtype))
        tbench.bump(ring)
        np.testing.assert_array_equal(ring.numpy(), np.asarray(want))


def test_device_anchor_sums_every_slot():
    """Each pass's anchor equals sum(pred) + sum(labels) of every slot,
    served one scan at a time and summed on the host in float32."""
    cfg = small_cfg()
    engine = _engine(cfg)
    base, _ = engine._prepare(tbench.load_scan(cfg))
    ring = tbench.make_ring(torch.from_numpy(base), 4)
    times, anchors = tbench.ring_rate(engine._dispatch, ring.clone(), 2,
                                      "cpu")
    assert len(times) == 2 and len(anchors) == 3
    counts = engine.counts()
    assert counts["scans"] == counts["eager_scans"] == 12
    assert counts["replays"] == counts["captures"] == 0
    for k, anchor in enumerate(anchors):
        if k:
            tbench.bump(ring)
        psum, lsum = np.float32(0), 0
        for i in range(4):
            pred, labels = engine.run(ring[i])
            psum = np.float32(psum + np.float32(pred.sum().item()))
            lsum += int(labels.to(torch.int64).sum())
        assert anchor == float(np.float32(psum + np.float32(lsum))), k


def test_bench_device_counts_both_engines(tmp_path, monkeypatch):
    """graph then eager: (1 + 3) passes over a 4-slot ring each; a CPU
    engine has no graph, so every scan runs eagerly; the same ring gives
    both the same anchor."""
    monkeypatch.setattr(tbench, "CACHE_DIR", str(tmp_path))
    cfg = small_cfg()
    out = tbench.bench_device(cfg, init_state_dict(cfg, seed=0), iters=8,
                              ring_size=4, device="cpu")
    assert list(out) == ["graph", "eager"]
    for res in out.values():
        assert res["scans"] == res["eager_scans"] == 16
        assert res["replays"] == 0
        assert len(res["runs_hz"]) == 3 and res["hz"] == max(res["runs_hz"])
    assert out["graph"]["anchor"] == out["eager"]["anchor"]
    assert sorted(os.listdir(tmp_path)) == ["aot_float32_4.json"]


def test_bench_batched_anchor_and_calls():
    cfg = small_cfg()
    out = tbench.bench_batched(cfg, init_state_dict(cfg, seed=0), iters=8,
                               batch=2, ring_size=4, device="cpu")
    assert list(out) == ["graph", "eager"]
    for res in out.values():
        assert res["calls"] == 4 * (1 + 3) and len(res["runs_hz"]) == 3
        # a CPU run has no graph: every call runs eagerly
        assert res["replays"] == 0 and res["eager_calls"] == res["calls"]
        assert np.isfinite(res["anchor"])
    assert out["graph"]["anchor"] == out["eager"]["anchor"]


# --- train mode -----------------------------------------------------------------

def test_bench_train_restores_state_between_runs():
    """Every timed run starts from the saved state: its first loss is the
    warm run's first loss, to the bit."""
    cfg = small_cfg()
    out = tbench.bench_train(cfg, iters=4, batch=2, device="cpu")
    assert list(out) == ["graph", "eager"]
    for res in out.values():
        assert res["steps"] == 5 * 4 and len(res["runs_hz"]) == 4
        assert res["replays"] == 0 and res["eager_steps"] == res["steps"]
        first = res["first_losses"]
        assert len(first) == 4 and len(set(first)) == 1
        assert np.isfinite(first[0]) and np.isfinite(res["anchor"])
    assert out["graph"]["first_losses"] == out["eager"]["first_losses"]


# --- accuracy mode ----------------------------------------------------------------

ACC = dict(fused_impl="scatter", compute_dtype="float32",
           matmul_precision="default", num_points=2048, batch_size=4,
           voxel_size=(2.0, 2.0, 8.0))


def _frames(cfg, n_frames=5, n=2048, seed=0):
    """Seed-made frames on the 50x50, 2 m grid: a tilted ground plane with
    boxes on it, and the plane's height per cell as the label."""
    rng = np.random.default_rng(seed)
    x0, y0, x1, y1 = cfg.grid_range
    clouds = np.zeros((n_frames, n, 4), np.float32)
    labels = np.zeros((n_frames, cfg.ny, cfg.nx), np.float32)
    for f in range(n_frames):
        a, b = rng.uniform(-0.01, 0.01, 2)
        x = rng.uniform(x0, x1, n)
        y = rng.uniform(y0, y1, n)
        z = a * x + b * y - cfg.lidar_height + rng.normal(0, 0.02, n)
        obstacle = rng.random(n) < 0.3
        z[obstacle] += rng.uniform(0.3, 2.0, obstacle.sum())
        clouds[f] = np.stack([x, y, z, rng.random(n)], axis=1)
        cx = x0 + (np.arange(cfg.nx) + 0.5) * cfg.voxel_size[0]
        cy = y0 + (np.arange(cfg.ny) + 0.5) * cfg.voxel_size[1]
        labels[f] = a * cx[None, :] + b * cy[:, None] - cfg.lidar_height
    return clouds, labels


def test_bench_accuracy_matches_jax(monkeypatch):
    """bench.bench_accuracy and the port's from the same flax init (JAX's
    create_train_state, carried over by state_dict_from_flax) on 5
    seed-made 2048-point frames, one epoch."""
    jcfg = jax_kitti_sem().replace(**ACC)
    cfg = kitti_sem_config().replace(**ACC)
    assert (cfg.ny, cfg.nx) == (50, 50)
    frames = _frames(cfg)
    init = {}
    jax_create = jtrain.create_train_state

    def capture(*args, **kwargs):
        model, tx, state = jax_create(*args, **kwargs)
        init["variables"] = jax.tree_util.tree_map(
            np.asarray, {"params": state.params,
                         "batch_stats": state.batch_stats})
        return model, tx, state

    monkeypatch.setattr(jtrain, "create_train_state", capture)
    want = jbench.bench_accuracy(jcfg, epochs=1, frames=frames)
    sd = state_dict_from_flax(init["variables"], cfg)
    torch_create = ttrain.create_train_state
    monkeypatch.setattr(ttrain, "create_train_state",
                        lambda *a, **kw: torch_create(*a, state_dict=sd,
                                                      **kw))
    got = tbench.bench_accuracy(cfg, epochs=1, frames=frames, device="cpu")
    assert set(got) == set(want)
    for key in ("rmse_before", "iou_before", "first_loss"):
        assert got[key] == pytest.approx(want[key], rel=1e-5), key
    for key in ("rmse_after", "final_loss"):
        assert got[key] == pytest.approx(want[key], rel=2e-2), key
    assert got["threshold_sweep"].keys() == want["threshold_sweep"].keys()
    for thr in want["threshold_sweep"].values():
        assert thr.keys() == {"iou", "precision", "recall"}
    for key in ("gate_m", "gate_iou", "gate_precision", "gate_recall",
                "seg_threshold", "epochs"):
        assert got[key] == want[key], key
    assert got["rmse_after"] != got["rmse_before"]


def test_bench_accuracy_without_the_fixture_raises():
    with pytest.raises(FileNotFoundError,
                       match="reference fixture dataset not available"):
        jbench.bench_accuracy(jax_kitti_sem())
    with pytest.raises(FileNotFoundError,
                       match="reference fixture dataset not available"):
        tbench.bench_accuracy(kitti_sem_config(), device="cpu")


# --- main --------------------------------------------------------------------------

@pytest.fixture
def small_yaml(tmp_path, monkeypatch):
    """A small config in the reference's flat YAML layout; small rings; the
    build directory put back after main moves it."""
    path = tmp_path / "small.yaml"
    with open(path, "w") as f:
        yaml.safe_dump({k: list(v) if isinstance(v, tuple) else v
                        for k, v in dataclasses.asdict(small_cfg()).items()
                        if not isinstance(v, dict)}, f)
    monkeypatch.setattr(tbench, "RING_SIZE", 4)
    monkeypatch.setattr(tbench, "BATCHED_RING_SCANS", 8)
    monkeypatch.setattr(tbench, "CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setattr(_ext, "BUILD_DIR", _ext.BUILD_DIR)
    return str(path)


@pytest.mark.parametrize("mode", sorted(MODE_KEYS))
def test_main_prints_one_line_per_mode(mode, small_yaml, capsys):
    rc = tbench.main(["--mode", mode, "--config", small_yaml, "--device",
                      "cpu", "--watchdog", "0", "--iters", "8", "--batch",
                      "2", "--target_hz", "1000"])
    lines = capsys.readouterr().out.splitlines()
    assert rc == 0 and len(lines) == 1
    line = json.loads(lines[0])
    assert BASE_KEYS | MODE_KEYS[mode] <= set(line)
    assert not PERF_FIELDS & set(line)
    assert line["device"] == {"platform": "cpu", "name": "cpu",
                              "power_limit_w": None}
    assert (line["mode"], line["config"], line["impl"]) == (
        mode, small_yaml, "affine")
    assert line["value"] > 0 and line["unit"] == "Hz"
    assert line["vs_baseline"] == round(line["value"] / 55.0, 2)
    assert all(np.isfinite(r) and r > 0 for r in line["runs_hz"])
    # a CPU run has no graph: nothing replays
    assert line["engine"] == "graph" and line["replays"] == 0
    assert line["eager"]["value"] > 0
    if mode not in ("batched", "train"):
        assert line["scans"] > 0


def test_main_accuracy_raises_without_the_fixture(small_yaml):
    with pytest.raises(FileNotFoundError):
        tbench.main(["--mode", "accuracy", "--config", small_yaml,
                     "--device", "cpu", "--watchdog", "0"])


def test_main_needs_the_card_by_default(small_yaml):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    with pytest.raises(RuntimeError, match="CUDA"):
        tbench.main(["--mode", "device", "--config", small_yaml,
                     "--watchdog", "0"])


def test_main_f32_is_the_parity_path(small_yaml, capsys):
    """--f32 keeps the configuration's float32 / 'highest' and takes
    'scatter'; --impl overrides it."""
    for flags, impl in (([], "scatter"), (["--impl", "affine"], "affine")):
        tbench.main(["--mode", "single", "--config", small_yaml, "--device",
                     "cpu", "--watchdog", "0", "--iters", "2", "--f32",
                     *flags])
        line = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert line["impl"] == impl and line["value"] > 0


# --- bench_turns ---------------------------------------------------------------------

def test_spread_and_summary():
    from gndnet_tpu_torch import bench_turns

    assert bench_turns.spread([3.0, 1.0, 2.0]) == {
        "min": 1.0, "median": 2.0, "max": 3.0}
    assert bench_turns.spread([4.0, 1.0])["median"] == 2.5
    lines = [{"case": c, "round": r, "value": v, "unit": "Hz",
              "device": {"platform": "cpu"},
              **({"eager": {"value": v / 2}} if c == "a" else {})}
             for r, (c, v) in enumerate([("a", 1.0), ("b", 5.0), ("a", 3.0),
                                         ("b", 7.0), ("a", 2.0),
                                         ("b", 6.0)])]
    a, b = bench_turns.summarize(lines)
    assert (a["case"], a["rounds"], a["values"], a["median"]) == (
        "a", 3, [1.0, 3.0, 2.0], 2.0)
    assert a["eager"] == {"values": [0.5, 1.5, 1.0], "min": 0.5,
                          "median": 1.0, "max": 1.5}
    assert (b["min"], b["median"], b["max"]) == (5.0, 6.0, 7.0)
    assert "eager" not in b


def test_bench_turns_runs_each_case_as_a_process(small_yaml, tmp_path,
                                                 monkeypatch):
    from gndnet_tpu_torch import bench_turns

    # --only keeps "single" and drops "device"
    monkeypatch.setattr(bench_turns, "CASES",
                        (("single", ["--mode", "single"]),
                         ("device", ["--mode", "device"])))
    out = tmp_path / "turns.jsonl"
    summary = bench_turns.main(
        ["--rounds", "2", "--only", "single", "--out", str(out), "--",
         "--config", small_yaml, "--device", "cpu", "--iters", "2",
         "--watchdog", "0"])
    assert len(summary) == 1 and summary[0]["rounds"] == 2
    assert summary[0]["case"] == "single"
    assert summary[0]["device"]["platform"] == "cpu"
    assert summary[0]["min"] > 0 and summary[0]["eager"]["min"] > 0
    assert len(out.read_text().splitlines()) == 3
