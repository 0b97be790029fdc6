"""Serving through the 'scatter' and 'sorted' impls: the port's
`GroundEstimatorNet.fused` (B=2, with and without use_norm's eval-mode BN)
and `GroundInferenceEngine.infer` against the JAX package from the same
variables, float32 / 'highest' on the CPU (JAX's sorted impl runs K7 in
interpret mode).  Elevation within rtol 1e-4 / atol 1e-5, labels equal
away from the threshold, as tests/test_torch_infer.py holds the affine
impl."""

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gndnet_tpu.config import GndNetConfig as JaxConfig
from gndnet_tpu.infer import GroundInferenceEngine as JaxEngine
from gndnet_tpu.models.gndnet import GroundEstimatorNet as JaxNet
from gndnet_tpu.models.gndnet import init_model
from gndnet_tpu_torch.config import GndNetConfig
from gndnet_tpu_torch.infer import GroundInferenceEngine
from gndnet_tpu_torch.models.gndnet import GroundEstimatorNet
from gndnet_tpu_torch.weights import state_dict_from_flax
from test_torch_infer import SMALL, THRESHOLD, _labels_agree, scene


@functools.lru_cache(maxsize=None)
def _variables(use_norm: bool):
    """JAX initial variables with random BN running statistics (the PFN's
    too under use_norm), so eval-mode batch norm is not the identity."""
    _, variables = init_model(JaxConfig(**{**SMALL, "use_norm": use_norm}),
                              seed=0)
    variables = jax.tree_util.tree_map(np.array, variables)
    rng = np.random.default_rng(0)
    stats = variables["batch_stats"]
    norms = [conv["bn"] for stage in stats["encoder_decoder"].values()
             for conv in stage.values()]
    if use_norm:
        norms.append(stats["voxel_feature_extractor"]["pfn_0"]["norm"])
    for bn in norms:
        n = bn["mean"].shape[0]
        bn["mean"] = rng.normal(0, 0.1, n).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return variables


def _cfgs(impl, use_norm=False):
    kw = {**SMALL, "fused_impl": impl, "use_norm": use_norm}
    return JaxConfig(**kw), GndNetConfig(**kw)


@pytest.mark.parametrize("impl", ["scatter", "sorted"])
@pytest.mark.parametrize("use_norm", [False, True])
def test_fused_matches_jax(impl, use_norm):
    jcfg, cfg = _cfgs(impl, use_norm)
    variables = _variables(use_norm)
    rng = np.random.default_rng(7)
    pts = np.stack([scene(rng, 600), scene(rng, 600)]) + np.float32(
        [0, 0, 1.7, 0])
    fused = jax.jit(functools.partial(JaxNet(jcfg).apply, train=False,
                                      method=JaxNet.fused))
    want = np.asarray(fused(variables, jnp.asarray(pts)))
    net = GroundEstimatorNet(cfg, device="cpu")
    net.load_state_dict(state_dict_from_flax(variables, cfg))
    got = net.fused(pts)
    assert got.shape == (2, 16, 16) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    assert np.abs(want).max() > 1e-3


@pytest.fixture(scope="module")
def engines():
    out = {}
    for impl in ("scatter", "sorted"):
        jcfg, cfg = _cfgs(impl)
        variables = _variables(False)
        out[impl] = (
            JaxEngine(jcfg, variables, threshold=THRESHOLD, bucket=256),
            GroundInferenceEngine(cfg, state_dict_from_flax(variables, cfg),
                                  threshold=THRESHOLD, bucket=256,
                                  device="cpu"))
    return out


@pytest.mark.parametrize("impl", ["scatter", "sorted"])
def test_engine_matches_jax_engine(engines, impl):
    jeng, teng = engines[impl]
    pts = scene(np.random.default_rng(11))
    elev_j, lab_j = jeng.infer(pts)
    elev_t, lab_t = teng.infer(pts)
    assert elev_t.shape == (16, 16) and lab_t.shape == (700,)
    np.testing.assert_allclose(elev_t, elev_j, rtol=1e-4, atol=1e-5)
    assert set(np.unique(lab_t)) <= {-1, 0, 1}
    _labels_agree(pts, elev_j, lab_j, lab_t, tol=1e-4)


def test_sorted_engine_matches_scatter_engine(engines):
    """The two impls of the port against each other, at the JAX package's
    own sorted-vs-scatter tolerance (tests/test_pillarize.py:300-301)."""
    pts = scene(np.random.default_rng(12))
    elev_a, _ = engines["scatter"][1].infer(pts)
    elev_s, _ = engines["sorted"][1].infer(pts)
    np.testing.assert_allclose(elev_s, elev_a, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("path", sorted(
    (pathlib.Path(__file__).resolve().parents[1] / "configs").glob("*.yaml")),
    ids=lambda p: p.name)
def test_shipped_yaml_canvas_runs_as_written(path):
    """Each shipped yaml ('scatter', float32, 'highest') loads and runs the
    port's canvas at its own grid and features: eval, and train with
    use_norm on (batch statistics, gradient to the PFN).  The full-width
    SegNet of these presets runs on the card (chip_smoke.py phases
    serve_scatter, serve_fine_grid, train_scatter, presets)."""
    cfg = GndNetConfig.from_yaml(str(path))
    assert cfg.fused_impl == "scatter"
    rng = np.random.default_rng(0)
    lo, hi = np.asarray(cfg.pc_range[:3]), np.asarray(cfg.pc_range[3:])
    pts = rng.uniform(lo, hi, (2, 400, 3)).astype(np.float32)
    pts = np.concatenate([pts, rng.uniform(0, 1, (2, 400, 1))], -1)
    pts = torch.from_numpy(pts[..., :cfg.input_features].astype(np.float32))
    for use_norm in (False, True):
        net = GroundEstimatorNet(cfg.replace(use_norm=use_norm), device="cpu")
        with torch.no_grad():
            canvas = net.canvas(pts)
        assert canvas.shape == (2, cfg.ny, cfg.nx, cfg.vfe_filters[-1])
        assert int((canvas != 0).any(-1).sum()) > 100
        train_canvas = net.canvas(pts, train=True)
        train_canvas.sum().backward()
        layer = net.voxel_feature_extractor.pfn_layers[0]
        assert all(p.grad is not None for p in layer.parameters())
