"""Multi-process plumbing of the port on the CPU: the localhost launcher,
the train CLI and `train_and_evaluate` over dp ranks with rank 0's
checkpoints resumed bit for bit, `replicate_global`'s SPMD check, and the
kernel build lock across processes.  Ranks are spawned over gloo
(`parallel.multihost.spawn`); nothing here needs JAX but the dataset's
config, which is the port's own."""

import os
import stat
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import yaml

from gndnet_tpu_torch.config import GndNetConfig
from gndnet_tpu_torch.parallel import multihost
from gndnet_tpu_torch.scripts import launch_multihost
from test_torch_train import SMALL, _labelled

JOBS = "gndnet_tpu_torch.parallel.rank_jobs:"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_launch_multihost_spawn2_ranks_agree(capsys):
    """`launch_multihost --spawn 2`: a dp=2 mesh over two ranks, each
    printing the same losses (the SPMD invariant)."""
    assert launch_multihost.main(["--spawn", "2", "--steps", "2",
                                  "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "mesh dp=2 x sp=1" in out and "ranks agree: True" in out
    losses = {r: [ln.split(" loss ")[1] for ln in out.splitlines()
                  if ln.startswith(f"[rank {r}] step")] for r in (0, 1)}
    assert len(losses[0]) == 2 and losses[0] == losses[1]


@pytest.mark.slow
def test_launch_multihost_spawn4_sp2_augmented():
    """dp=2 x sp=2 with on-device augmentation, as a user runs it."""
    proc = subprocess.run(
        [sys.executable, "-m", "gndnet_tpu_torch.scripts.launch_multihost",
         "--spawn", "4", "--sp", "2", "--augment", "--steps", "3",
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "mesh dp=2 x sp=2" in proc.stdout
    assert "ranks agree: True" in proc.stdout


def test_replicate_global_checks_the_spmd_invariant(tmp_path):
    results = multihost.spawn(JOBS + "replicate_job", 3,
                              kwargs=dict(n_frames=10), device="cpu",
                              workdir=str(tmp_path))
    assert [r["slice"] for r in results] == [(0, 3), (3, 6), (6, 10)]
    assert [r["axis"] for r in results] == [(3, 0), (3, 1), (3, 2)]
    for r in results:
        assert torch.equal(r["same"], torch.arange(6.0))
        assert "held other values than rank 0's" in r["error"]


def test_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group of 4 ranks"):
        multihost.global_mesh(2, 2)
    assert multihost.choose_backend("cpu", 2) == "gloo"
    if torch.cuda.device_count() < 2:
        assert multihost.choose_backend("cuda", 2) == "gloo"
        assert multihost.choose_backend(None, 2) == "gloo"
    assert multihost.process_slice(10, 4) == slice(0, 10)


def test_ranks_default_to_the_card():
    """With no device named, the ranks of `spawn` and of the launcher run
    on the cards: where there is none they raise before any rank starts,
    and never fall back to the CPU."""
    if torch.cuda.is_available():
        assert multihost.local_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.spawn(JOBS + "replicate_job", 2, kwargs=dict(n_frames=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_multihost.main(["--spawn", "2"])


def test_spawn_reports_a_failing_rank(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1"):
        multihost.spawn(JOBS + "replicate_job", 2,
                        kwargs=dict(n_frames="not a number"),
                        device="cpu", workdir=str(tmp_path))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """tests/test_torch_cli.py's tiny dataset (4 training, 2 validation
    frames) and its config as a flat YAML."""
    root = tmp_path_factory.mktemp("data")
    kw = dict(SMALL, num_points=600, max_memory=100.0, data_dir=str(root))
    cfg = GndNetConfig(**kw)
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
    path.write_text(yaml.safe_dump({k: list(v) if isinstance(v, tuple)
                                    else v for k, v in kw.items()}))
    return cfg, str(path)


def test_dp2_checkpoint_resume_is_bit_identical(dataset, tmp_path):
    """train_and_evaluate over dp=2 ranks: rank 0 alone writes the
    checkpoints, both ranks resume from them, and 1 epoch + 1 resumed
    epoch give the losses and bits of 2 unbroken epochs."""
    cfg, _ = dataset
    results = multihost.spawn(
        JOBS + "resume_job", 2, device="cpu",
        workdir=str(tmp_path / "ranks"),
        kwargs=dict(cfg=cfg, workdir=str(tmp_path), dp=2, sp=1, epochs=2,
                    resume_at=1))
    for r in results:
        assert r["resumed"] == r["full"] and len(r["full"]) == 2
        assert r["steps"] == (4, 4)
        for k, v in r["full_state"].items():
            assert torch.equal(r["resumed_state"][k], v), k
            assert torch.equal(results[0]["full_state"][k], v), k
    ckpt = tmp_path / "resumed" / "checkpoints"
    assert sorted(os.listdir(ckpt)) == sorted([
        "checkpoint.pth.tar", "checkpoint_1.pth.tar", "checkpoint_2.pth.tar",
        "model_best.pth.tar"])
    log = (tmp_path / "resumed" / "training.log").read_text()
    assert "mesh: dp=2 x sp=1 over 2 ranks" in log
    assert "resumed from epoch 1" in log


def test_train_cli_over_two_ranks(dataset, tmp_path):
    """`scripts/train.py --dp 2` in each of two ranks (the torchrun
    launch): trains, checkpoints once, and both ranks hold the same
    weights."""
    _, cfg_path = dataset
    argv = ["--config", cfg_path, "--workdir", str(tmp_path / "run"),
            "--dp", "2", "-s", "--epochs", "1", "--train_skip", "1",
            "--valid_skip", "1", "--device", "cpu"]
    results = multihost.spawn(JOBS + "cli_job", 2, kwargs=dict(argv=argv),
                              device="cpu", workdir=str(tmp_path / "ranks"))
    assert results[0]["train_loss"] == results[1]["train_loss"]
    assert np.isfinite(results[0]["valid_loss"]).all()
    for k, v in results[0]["state_dict"].items():
        assert torch.equal(results[1]["state_dict"][k], v), k
    assert (tmp_path / "run" / "checkpoints" / "checkpoint_1.pth.tar").exists()


FAKE_NVCC = textwrap.dedent('''\
    #!{python}
    """Stands in for nvcc: counts its calls, waits, then builds a library
    exporting the one entry the test loads."""
    import os, subprocess, sys, time
    with open(os.environ["FAKE_NVCC_LOG"], "a") as f:
        f.write("call\\n")
    time.sleep(1.0)
    out = sys.argv[sys.argv.index("-o") + 1]
    src = out + ".c"
    with open(src, "w") as f:
        f.write("int cell_histogram_capacity(void) {{ return 7; }}\\n")
    subprocess.run(["gcc", "-shared", "-fPIC", "-o", out, src], check=True)
    os.remove(src)
    ''')


def test_concurrent_builds_make_one_library(tmp_path):
    """Two processes loading the same kernel library at once: the file
    lock in the build directory lets one build it and the other load it
    (one nvcc call, one .so, no temporary left)."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    build = tmp_path / "build"
    log = tmp_path / "calls.log"
    env = dict(os.environ, PATH=f"{bindir}{os.pathsep}{os.environ['PATH']}",
               FAKE_NVCC_LOG=str(log), PYTHONPATH=REPO)
    code = ("import sys\n"
            "from gndnet_tpu_torch import _ext\n"
            "_ext.BUILD_DIR = sys.argv[1]\n"
            "print(_ext.function('cell_histogram_capacity')())\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert [o.strip().splitlines()[-1] for o in outs] == ["7", "7"]
    assert log.read_text().count("call") == 1
    libs = [f for f in os.listdir(build) if f.startswith("libcell_hist")]
    assert len(libs) == 1 and libs[0].endswith(".so")
