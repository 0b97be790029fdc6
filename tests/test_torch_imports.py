"""gndnet_tpu_torch stands alone: no JAX, no gndnet_tpu, its own config,
and the card by default."""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import gndnet_tpu.config as jcfg
from gndnet_tpu_torch import _ext, config as tcfg
from gndnet_tpu_torch.infer import GroundInferenceEngine
from gndnet_tpu_torch.models.gndnet import GroundEstimatorNet
from gndnet_tpu_torch.train import create_train_state, train_and_evaluate
from gndnet_tpu_torch.weights import init_state_dict

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "gndnet_tpu_torch"
JAX_ROOTS = ("jax", "jaxlib", "flax", "optax", "orbax")


def _is_jax_side(name: str) -> bool:
    """Exact module-name test: `gndnet_tpu_torch` starts with the string
    `gndnet_tpu` but is not part of that package."""
    return (name.split(".")[0] in JAX_ROOTS or name == "gndnet_tpu"
            or name.startswith("gndnet_tpu."))


def test_is_jax_side_compares_names_exactly():
    assert _is_jax_side("gndnet_tpu") and _is_jax_side("gndnet_tpu.ops")
    assert _is_jax_side("jax.numpy") and _is_jax_side("flax")
    assert not _is_jax_side("gndnet_tpu_torch")
    assert not _is_jax_side("gndnet_tpu_torch.ops.sort")
    assert not _is_jax_side("jaxtyping_like")


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import gndnet_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'gndnet_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('\\n'.join(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    assert "gndnet_tpu_torch.infer" in out
    assert "gndnet_tpu_torch.ops.affine" in out
    assert "gndnet_tpu_torch.ops.affine_aux" in out
    assert "gndnet_tpu_torch.profile_affine" in out
    assert "gndnet_tpu_torch.train" in out
    assert "gndnet_tpu_torch.data.provider" in out
    for name in ("io_shim", "native", "checkpoint", "ops.transforms",
                 "utils.compile_cache", "serving.replay",
                 "serving.ros_node", "evaluate", "ops.postproc",
                 "data.augmentation", "data.generator", "synthetic",
                 "scripts.evaluate", "scripts.generate_data",
                 "scripts.train", "scripts.predict",
                 "scripts.convert_checkpoint", "scripts.plot_losses",
                 "ops.scatter", "utils.logging", "utils.schedules",
                 "parallel.mesh", "parallel.spatial", "parallel.tp",
                 "parallel.multihost", "parallel.collectives",
                 "parallel.rank_jobs", "utils.perf_model",
                 "utils.profiling", "scripts.launch_multihost", "bench",
                 "scripts.augmentation_demo"):
        assert f"gndnet_tpu_torch.{name}" in out
    assert [m for m in out if _is_jax_side(m)] == []
    assert "bench" not in out       # the JAX package's root bench.py


@pytest.mark.parametrize("path", sorted(
    [*PKG.rglob("*.py"), REPO / "chip_smoke.py"]), ids=lambda p: p.name)
def test_sources_import_no_jax(path):
    tree = ast.parse(path.read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert [n for n in names if _is_jax_side(n) or n == "bench"] == []


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_config_presets_match_jax(name):
    assert (dataclasses.asdict(tcfg.load_config(name))
            == dataclasses.asdict(jcfg.load_config(name)))


@pytest.mark.parametrize("path", sorted((REPO / "configs").glob("*.yaml")),
                         ids=lambda p: p.name)
def test_config_yaml_matches_jax(path):
    assert (dataclasses.asdict(tcfg.GndNetConfig.from_yaml(str(path)))
            == dataclasses.asdict(jcfg.GndNetConfig.from_yaml(str(path))))


def test_config_validation_matches_jax():
    for bad in ({"fused_impl": "nope"}, {"compute_dtype": "f16"},
                {"input_features": 2}, {"max_points_voxel": 0}):
        with pytest.raises(ValueError):
            jcfg.GndNetConfig(**bad)
        with pytest.raises(ValueError):
            tcfg.GndNetConfig(**bad)


def test_default_device_is_the_card():
    """Entry points run on CUDA unless told otherwise and never fall back
    to the CPU: on a host without a card the default raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    cfg = tcfg.kitti_sem_config().replace(fused_impl="affine")
    with pytest.raises(RuntimeError, match="CUDA"):
        _ext.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        GroundEstimatorNet(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        GroundInferenceEngine(cfg, init_state_dict(cfg, seed=0))
    with pytest.raises(RuntimeError, match="CUDA"):
        create_train_state(cfg, steps_per_epoch=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_and_evaluate(cfg, epochs=0)
    assert _ext.resolve_device("cpu") == torch.device("cpu")


def test_out_of_slice_paths_raise_not_implemented():
    """B=2 serving and training run through 'affine' and 'scatter';
    'sorted' serves but does not train.  Grids whose packed (cell, index)
    key overflows 31 bits no longer raise on the affine impl: fine_grid
    (62 500 cells) with 32 769-point scans serves at B=1 (K10's pair
    sort) and trains at B=2 (the stable batched sort) on the CPU."""
    rng = np.random.default_rng(0)
    small = dict(pc_range=(0.0, -8.0, -4.0, 16.0, 8.0, 4.0),
                 grid_range=(0.0, -8.0, 16.0, 8.0), max_points_voxel=20)
    pts = torch.from_numpy(rng.uniform(0, 8, (2, 64, 4)).astype(np.float32))
    for impl in ("affine", "scatter"):
        cfg = tcfg.GndNetConfig(fused_impl=impl, **small)
        net = GroundEstimatorNet(cfg, device="cpu")
        assert net.fused(pts).shape == (2, cfg.ny, cfg.nx)
        pred = net.fused(pts, train=True)
        assert pred.shape == (2, cfg.ny, cfg.nx) and pred.requires_grad
        pred.sum().backward()
        assert all(p.grad is not None for p in net.parameters())
    net = GroundEstimatorNet(cfg.replace(fused_impl="sorted"), device="cpu")
    assert net.fused(pts).shape == (2, cfg.ny, cfg.nx)
    with pytest.raises(NotImplementedError, match="no gradient"):
        net.fused(pts, train=True)
    fine = tcfg.fine_grid_config().replace(fused_impl="affine")
    n = 32_769
    assert fine.nx * fine.ny * (1 << (n - 1).bit_length()) >= 2**31
    scans = np.zeros((2, n, 4), np.float32)
    scans[..., :2] = rng.uniform(-50, 50, (2, n, 2))
    scans[..., 2] = rng.uniform(-2, 1, (2, n))
    net = GroundEstimatorNet(fine, device="cpu")
    elev = net.fused(torch.from_numpy(scans[:1]))
    assert elev.shape == (1, 250, 250) and bool(torch.isfinite(elev).all())
    pred = net.fused(torch.from_numpy(scans), train=True)
    pred.sum().backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in net.parameters())
