"""The port's train / predict / convert_checkpoint / plot_losses CLIs on
the CPU (`--device cpu`), the checkpoint manager they reach, the
schedules and the streaming metrics, against the JAX package.

Tolerances: schedules rtol 1e-6 (both compute in float32); metrics,
parsed logs, loaded clouds and converted checkpoints equal; `predict`'s
elevation and labels equal to the engine's `infer` on the same weights."""

import importlib.util
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from gndnet_tpu.checkpoint import load_torch_checkpoint as jax_load
from gndnet_tpu.config import GndNetConfig as JaxConfig
from gndnet_tpu.utils import logging as jlog
from gndnet_tpu.utils import schedules as jsched
from gndnet_tpu_torch import train
from gndnet_tpu_torch.checkpoint import (BEST, CHECKPOINT,
                                         CheckpointManager, checkpoint_dict,
                                         load_weights)
from gndnet_tpu_torch.config import GndNetConfig, load_config
from gndnet_tpu_torch.infer import GroundInferenceEngine
from gndnet_tpu_torch.scripts import augmentation_demo as demo_cli
from gndnet_tpu_torch.scripts import convert_checkpoint as convert_cli
from gndnet_tpu_torch.scripts import plot_losses as plot_cli
from gndnet_tpu_torch.scripts import predict as predict_cli
from gndnet_tpu_torch.scripts import train as train_cli
from gndnet_tpu_torch.utils import logging as tlog
from gndnet_tpu_torch.utils import schedules as tsched
from test_torch_train import SMALL, _labelled

REPO = pathlib.Path(__file__).resolve().parents[1]


def _jax_script(name):
    """scripts/<name>.py of the JAX package, imported from its file."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# --- schedules and metrics --------------------------------------------------

SCHEDULES = {
    "constant": lambda m: m.constant_lr(0.05),
    "manual": lambda m: m.manual_stepping([3, 7, 12], [0.1, 0.05, 0.01,
                                                       0.001]),
    "burnin_staircase": lambda m: m.exponential_decay_with_burnin(
        0.1, 4, 0.8, burnin_learning_rate=0.01, burnin_steps=3),
    "smooth": lambda m: m.exponential_decay_with_burnin(
        0.1, 4, 0.8, staircase=False),
    "cosine": lambda m: m.cosine_decay_with_warmup(
        0.1, 36, warmup_learning_rate=0.01, warmup_steps=5,
        hold_base_rate_steps=3),
    "cosine_plain": lambda m: m.cosine_decay_with_warmup(0.1, 36),
    "step_lr": lambda m: m.step_lr(0.1, 2, 0.8, 3),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_jax(name):
    """Steps 0 to 3x the last boundary (12, 36 and the rest: 36), against
    the JAX schedule as its jitted train step applies it (traced: the
    port's Python-step form returns the rate its train step applies)."""
    want = jax.jit(SCHEDULES[name](jsched))
    got = SCHEDULES[name](tsched)
    for step in range(37):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6,
                                          abs=0.0), step
    with pytest.raises(ValueError):
        tsched.manual_stepping([1, 2], [0.1])


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    pairs = [(rng.integers(0, 3, 50), rng.integers(0, 3, 50))
             for _ in range(3)]
    masks = [(rng.random(40) < 0.5, rng.random(40) < 0.3)
             for _ in range(3)]
    j = (jlog.Scalar(), jlog.Accuracy(), jlog.PrecisionRecall())
    t = (tlog.Scalar(), tlog.Accuracy(), tlog.PrecisionRecall())
    for k, ((p, q), (a, b)) in enumerate(zip(pairs, masks)):
        for side in (j, t):
            side[0].update(float(p.mean()), n=k + 1)
            side[1].update(p, q)
            side[2].update(a, b)
    assert t[0].value == j[0].value and t[1].value == j[1].value
    for key in ("tp", "fp", "fn", "precision", "recall", "iou"):
        assert getattr(t[2], key) == getattr(j[2], key), key
    t[0].clear(), t[1].clear()
    assert t[0].value == 0.0 and t[1].value == 0.0


def test_create_run_dir(tmp_path):
    path = tlog.create_run_dir(str(tmp_path), prefix="exp")
    assert os.path.isdir(path) and os.path.basename(path).startswith("exp-")


# --- the checkpoint manager -------------------------------------------------

def test_checkpoint_manager_keeps_latest_and_best(tmp_path):
    """max_to_keep garbage collection, the latest and best copies, restore
    of the latest step, of a given step and of the best, and JAX's
    `load_torch_checkpoint` reading every file the manager writes."""
    cfg = GndNetConfig(**SMALL)
    state = train.create_train_state(cfg, 10, device="cpu")
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    assert mgr.latest_step() is None and mgr.restore() is None
    assert mgr.restore_best() is None
    pts, labels = _labelled(np.random.default_rng(0), cfg)
    weights = {}
    for step, best in ((1, True), (2, False), (3, True), (4, False)):
        train.make_train_step(cfg)(state, pts, labels)
        mgr.save(step, checkpoint_dict(state, step, 1.0 / step),
                 is_best=best)
        weights[step] = {k: v.clone() for k, v in
                         state.model.state_dict().items()}
    assert mgr.steps() == [3, 4] and mgr.latest_step() == 4
    names = sorted(os.listdir(mgr.directory))
    assert names == sorted([BEST, CHECKPOINT, "checkpoint_3.pth.tar",
                            "checkpoint_4.pth.tar"])
    for ckpt, step in ((mgr.restore(), 4), (mgr.restore(3), 3),
                       (mgr.restore_best(), 3)):
        assert ckpt["epoch"] == step
        for k, v in ckpt["state_dict"].items():
            assert torch.equal(v, weights[step][k]), k
    assert ckpt["optimizer"]["count"] == 3
    jcfg = JaxConfig(**SMALL)
    for name in names:
        loaded = jax_load(os.path.join(mgr.directory, name), jcfg)
        assert loaded["epoch"] in (3, 4)
    latest = torch.load(os.path.join(mgr.directory, CHECKPOINT),
                        weights_only=False)
    assert latest["epoch"] == 4
    for k, v in load_weights(mgr.directory).items():
        assert torch.equal(v, weights[4][k])
    mgr.close()


# --- the CLIs ---------------------------------------------------------------

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """tests/test_torch_train_loop.py's tiny dataset and its config as a
    YAML file in the reference's flat layout."""
    root = tmp_path_factory.mktemp("data")
    cfg = GndNetConfig(**SMALL).replace(num_points=600, max_memory=100.0,
                                        data_dir=str(root))
    rng = np.random.default_rng(8)
    for split, k in (("training", 4), ("validation", 2)):
        d = root / split / "seq_000"
        (d / "reduced_velo").mkdir(parents=True)
        (d / "gnd_labels").mkdir()
        for i in range(k):
            pts, labels = _labelled(rng, cfg, b=1)
            np.save(d / "reduced_velo" / f"{i:06d}.npy", pts[0])
            np.save(d / "gnd_labels" / f"{i:06d}.npy",
                    labels[0].astype(np.float64))
    path = root / "small.yaml"
    path.write_text(yaml.safe_dump(
        {k: list(v) if isinstance(v, tuple) else v
         for k, v in dict(SMALL, num_points=600, max_memory=100.0,
                          data_dir=str(root)).items()}))
    assert load_config(str(path)) == cfg
    return root, str(path)


@pytest.fixture(scope="module")
def trained(dataset, tmp_path_factory):
    """`train -s` for two epochs, then `-e` on its checkpoint."""
    root, cfg_path = dataset
    run = tmp_path_factory.mktemp("run")
    base = ["--config", cfg_path, "--workdir", str(run), "--train_skip",
            "1", "--valid_skip", "1", "-p", "1", "--device", "cpu"]
    hist = train_cli.main(base + ["-s", "--epochs", "2"])
    evaluated = train_cli.main(base + ["-e"])
    return run, hist, evaluated


def test_train_cli_trains_checkpoints_and_evaluates(trained):
    run, hist, evaluated = trained
    assert len(hist["train_loss"]) == 2 and hist["state"].step == 4
    ckpt = run / "checkpoints"
    assert (ckpt / CHECKPOINT).exists() and (ckpt / BEST).exists()
    assert CheckpointManager(str(ckpt)).steps() == [1, 2]
    # -e resumed the last epoch's weights and validated them once
    assert evaluated["state"].step == 4
    assert evaluated["valid_loss"] == [pytest.approx(
        hist["valid_loss"][-1], rel=1e-5)]
    for k, v in evaluated["state"].model.state_dict().items():
        assert torch.equal(v, hist["state"].model.state_dict()[k]), k
    log = (run / "training.log").read_text()
    assert "resumed from epoch 2" in log and "validation only" in log


def test_train_cli_parallel_sizes_raise(dataset, tmp_path):
    _, cfg_path = dataset
    with pytest.raises(ValueError, match="needs 2 ranks, this run has 1"):
        train_cli.main(["--config", cfg_path, "--workdir", str(tmp_path),
                        "--dp", "2", "--device", "cpu"])


def test_parse_log_file_matches_jax(trained, tmp_path):
    """Both packages' parsers read the log the port's train CLI wrote, and
    plot_losses writes its PNG."""
    run, hist, _ = trained
    log = str(run / "training.log")
    got, want = tlog.parse_log_file(log), jlog.parse_log_file(log)
    assert got == want
    assert got["epochs"] == [0, 1] and len(got["valid_loss"]) >= 2
    assert got["train_loss"] == [pytest.approx(x, abs=1e-6)
                                 for x in hist["train_loss"]]
    out = tmp_path / "losses.png"
    assert plot_cli.main([log, "--out", str(out)]) == got
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_load_cloud_matches_jax(tmp_path):
    jax_predict = _jax_script("predict")
    rng = np.random.default_rng(4)
    npy, binf = tmp_path / "scan.npy", tmp_path / "scan.bin"
    np.save(npy, rng.normal(size=(50, 3)).astype(np.float64))
    rng.normal(size=(60, 4)).astype(np.float32).tofile(binf)
    for path in (npy, binf):
        for shift in (False, True):
            for f in (3, 4, 5):
                want = jax_predict.load_cloud(str(path), f, 1.7, shift)
                got = predict_cli.load_cloud(str(path), f, 1.7, shift)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)


def test_predict_cli_matches_engine(trained, dataset, tmp_path, capsys):
    """`predict` from the trained run's checkpoint directory and from its
    .pth.tar: elevation and labels equal to the engine's `infer` on the
    same weights and cloud, saved with --out, drawn with --viz; the same
    two lines of counts and range as JAX's CLI."""
    run, _, _ = trained
    root, cfg_path = dataset
    cfg = load_config(cfg_path)
    scan = root / "training" / "seq_000" / "reduced_velo" / "000001.npy"
    sd = load_weights(str(run / "checkpoints"))
    engine = GroundInferenceEngine(cfg, sd, threshold=0.1, device="cpu")
    cloud = predict_cli.load_cloud(str(scan), cfg.input_features,
                                   cfg.lidar_height, cfg.shift_cloud)
    want_elev, want_labels = engine.infer(cloud)
    out, png = tmp_path / "pred", tmp_path / "view.png"
    for resume in (run / "checkpoints", run / "checkpoints" / CHECKPOINT):
        elev, labels = predict_cli.main([
            "--config", cfg_path, "--pcl", str(scan), "--resume",
            str(resume), "--threshold", "0.1", "--out", str(out), "--viz",
            str(png), "--device", "cpu"])
        np.testing.assert_array_equal(elev, want_elev)
        np.testing.assert_array_equal(labels, want_labels)
    printed = capsys.readouterr().out.splitlines()
    n = len(cloud)
    assert printed[0] == (
        f"points: {n}  ground: {int((want_labels == 0).sum())}  obstacle: "
        f"{int((want_labels == 1).sum())}  outside: "
        f"{int((want_labels == -1).sum())}")
    assert printed[1].startswith(f"elevation: shape {want_elev.shape}")
    np.testing.assert_array_equal(np.load(f"{out}_elevation.npy"),
                                  want_elev)
    np.testing.assert_array_equal(np.load(f"{out}_segmentation.npy"),
                                  want_labels)
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_predict_runs_as_a_module(trained, dataset):
    """`python -m gndnet_tpu_torch.scripts.predict ... --device cpu` in a
    fresh process."""
    run, _, _ = trained
    root, cfg_path = dataset
    scan = root / "validation" / "seq_000" / "reduced_velo" / "000000.npy"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    done = subprocess.run(
        [sys.executable, "-m", "gndnet_tpu_torch.scripts.predict",
         "--config", cfg_path, "--pcl", str(scan), "--resume",
         str(run / "checkpoints"), "--device", "cpu"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120, check=True)
    assert done.stdout.startswith("points: 600  ground: ")


def test_convert_checkpoint_round_trips_bit_equal(trained, dataset,
                                                  tmp_path, capsys):
    """.pth.tar -> directory -> .pth.tar and back: every tensor equal, the
    epoch and lowest loss kept, JAX's "loaded: ..." line printed, and JAX's
    loader reading the result."""
    run, hist, _ = trained
    _, cfg_path = dataset
    src = run / "checkpoints" / CHECKPOINT
    first = torch.load(src, weights_only=False)
    d1, t1, d2 = tmp_path / "d1", tmp_path / "t1.pth.tar", tmp_path / "d2"
    convert_cli.main(["--config", cfg_path, "--from-torch", str(src),
                      "--to-dir", str(d1)])
    convert_cli.main(["--config", cfg_path, "--from-dir", str(d1),
                      "--to-torch", str(t1), "--to-dir", str(d2)])
    n = sum(v.numel() for k, v in first["state_dict"].items()
            if "running" not in k and "num_batches" not in k)
    printed = capsys.readouterr().out.splitlines()
    assert printed[0] == (f"loaded: epoch 2, lowest_loss "
                          f"{first['lowest_loss']}, {n / 1e6:.2f}M params")
    for ckpt in (torch.load(t1, weights_only=False),
                 CheckpointManager(str(d1)).restore(2),
                 CheckpointManager(str(d2)).restore()):
        assert ckpt["epoch"] == 2
        assert ckpt["lowest_loss"] == first["lowest_loss"]
        assert ckpt["state_dict"].keys() == first["state_dict"].keys()
        for k, v in first["state_dict"].items():
            assert torch.equal(ckpt["state_dict"][k], v), k
    assert jax_load(str(t1), JaxConfig(**SMALL))["epoch"] == 2
    with pytest.raises(SystemExit):
        convert_cli.main(["--config", cfg_path, "--to-dir", str(d1)])


@pytest.mark.parametrize("noise", [False, True], ids=["plain", "noise"])
def test_augmentation_demo_matches_jax(tmp_path, monkeypatch, noise):
    """The same argv through both demos, `render` captured on both sides
    and every unseeded `np.random.default_rng()` seeded with 0: the
    original and each augmented cloud array-equal, the same paths and
    titles."""
    rng = np.random.default_rng(0)
    scan = np.zeros((3000, 4), np.float32)
    scan[:, :2] = rng.uniform(-20, 20, (3000, 2))
    scan[:, 2] = rng.uniform(-2.2, 0.5, 3000)
    scan[:, 3] = rng.uniform(0, 1, 3000)
    pcl = tmp_path / "scan.npy"
    np.save(pcl, scan)
    default_rng = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda seed=None: default_rng(
                            0 if seed is None else seed))
    jax_demo = _jax_script("augmentation_demo")
    rendered = {}
    for side, module in (("jax", jax_demo), ("torch", demo_cli)):
        calls = rendered[side] = []
        monkeypatch.setattr(module, "render",
                            lambda path, cloud, title, calls=calls:
                            calls.append((os.path.basename(path), title,
                                          np.array(cloud))))
        argv = ["--config", "kitti_sem", "--pcl", str(pcl), "--n", "3",
                "--out", str(tmp_path / side)] + (["--noise"] if noise
                                                   else [])
        if module is jax_demo:
            monkeypatch.setattr(sys, "argv", ["augmentation_demo.py", *argv])
            module.main()
        else:
            module.main(argv)
    assert len(rendered["torch"]) == 4
    for (jp, jt, jc), (tp, tt, tc) in zip(rendered["jax"], rendered["torch"],
                                          strict=True):
        assert (jp, jt) == (tp, tt)
        np.testing.assert_array_equal(tc, jc)
    assert not np.array_equal(rendered["torch"][1][2], scan)
