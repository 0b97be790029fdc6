"""The port's `evaluate.py` against `gndnet_tpu.evaluate`: the metric
plumbing of tests/test_infer_eval.py (perfect prediction, the reference
oracle, the golden metrics, the ground-truth classes), then the whole
SemanticKITTI harness and the height RMSE on the same weights and frames,
at float32 / 'highest' on a 16 x 16 grid, through 'affine' and 'scatter'."""

import ast

import numpy as np
import pytest
import torch
import yaml

from gndnet_tpu import evaluate as jev
from gndnet_tpu.checkpoint import import_torch_state_dict
from gndnet_tpu.config import GndNetConfig as JaxConfig
from gndnet_tpu_torch import evaluate as tev
from gndnet_tpu_torch.checkpoint import CheckpointManager
from gndnet_tpu_torch.config import GndNetConfig
from gndnet_tpu_torch.data.generator import generate_sequence
from gndnet_tpu_torch.infer import GroundInferenceEngine
from gndnet_tpu_torch.scripts import evaluate as eval_cli
from gndnet_tpu_torch.synthetic import (synthetic_semantic_kitti_scan,
                                        write_semantic_kitti_sequence)
from gndnet_tpu_torch.weights import init_state_dict

# the 16 x 16 config of tests/test_infer_eval.py at float32 / 'highest'
SMALL = dict(pc_range=(0.0, -8.0, -4.0, 16.0, 8.0, 4.0),
             grid_range=(0.0, -8.0, 16.0, 8.0), voxel_size=(1.0, 1.0, 8.0),
             max_points_voxel=20, max_voxels=256, input_features=4,
             num_points=512, lidar_height=1.7, use_norm=False,
             compute_dtype="float32", matmul_precision="highest",
             batch_size=2)
METRIC_ATOL = 1e-6      # IoU, precision, recall
MSE_RTOL = 1e-5         # height MSE and RMSE
FRAMES = 3


def configs(impl):
    return (JaxConfig(**SMALL, fused_impl=impl),
            GndNetConfig(**SMALL, fused_impl=impl))


@pytest.fixture(scope="module")
def weights():
    """Random weights with non-trivial batch-norm statistics, for the port
    and, through the JAX package's bridge, for JAX."""
    cfg = GndNetConfig(**SMALL)
    sd = init_state_dict(cfg, seed=0)
    rng = np.random.default_rng(0)
    for name, t in sd.items():
        if name.endswith("running_mean"):
            t.copy_(torch.from_numpy(rng.normal(0, 0.1, t.shape)))
        elif name.endswith("running_var"):
            t.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, t.shape)))
    variables = import_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()}, JaxConfig(**SMALL))
    return sd, variables


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    """A SemanticKITTI-layout sequence of FRAMES synthetic scans."""
    seq = tmp_path_factory.mktemp("kitti") / "sequences" / "00"
    rng = np.random.default_rng(11)
    _, cfg = configs("affine")
    write_semantic_kitti_sequence(
        str(seq), [synthetic_semantic_kitti_scan(cfg, rng, 900)
                   for _ in range(FRAMES)])
    return seq


def plane_cloud(rng, n=400, z=-1.7):
    pts = np.zeros((n, 4), np.float32)
    pts[:, 0] = rng.uniform(0.2, 15.8, n)
    pts[:, 1] = rng.uniform(-7.8, 7.8, n)
    pts[:, 2] = z + rng.normal(0, 0.01, n)
    return pts


# --- tests/test_infer_eval.py:172-250 on the port ---------------------------

def test_evaluate_frames_perfect_prediction_is_high_iou(weights):
    sd, _ = weights
    _, cfg = configs("affine")
    rng = np.random.default_rng(1234)
    cloud = plane_cloud(rng, n=500, z=-cfg.lidar_height)
    cloud[:100, 2] = 2.0
    labels = np.full(500, 40, np.uint32)   # ground class
    labels[:100] = 10                      # car -> obstacle
    labels[490:] = 0                       # unlabeled -> excluded
    res = tev.evaluate_frames(cfg, sd, [(cloud[:, :3], labels)],
                              threshold=0.0, device="cpu")
    assert res.frames == 1
    assert 0.0 <= res.iou <= 1.0
    assert res.mse >= 0.0
    assert set(res.as_dict()) == {"frames", "iou", "precision", "recall",
                                  "mse"}


def test_evaluate_frames_matches_reference_oracle(weights):
    """The whole harness against tests/oracles.py's sequential re-derivation
    of reference evaluate_SemanticKITTI.py:94-235 at reference_compat."""
    from oracles import eval_frame_oracle

    sd, _ = weights
    _, cfg = configs("affine")
    rng = np.random.default_rng(3)
    n = 600
    cloud = np.zeros((n, 3), np.float32)
    cloud[:, 0] = rng.uniform(-1.0, 17.0, n)
    cloud[:, 1] = rng.uniform(-9.0, 9.0, n)
    cloud[:, 2] = rng.uniform(-2.2, -1.2, n)
    cloud[:150, 2] = rng.uniform(0.0, 2.0, 150)
    sem = rng.choice(np.array([40, 44, 48, 72, 10, 30, 0, 1], np.uint32), n)
    res = tev.evaluate_frames(cfg, sd, [(cloud, sem)], threshold=0.0,
                              reference_compat=True, device="cpu")
    engine = GroundInferenceEngine(cfg, sd, threshold=0.0, shift_cloud=True,
                                   device="cpu")
    pred, _ = engine.infer(cloud)
    iou, prec, rec, mse = eval_frame_oracle(
        pred, cloud, sem, cfg.grid_range, cfg.voxel_size[0],
        cfg.lidar_height, threshold=0.0)
    assert res.iou == pytest.approx(iou, abs=1e-9)
    assert res.precision == pytest.approx(prec, abs=1e-9)
    assert res.recall == pytest.approx(rec, abs=1e-9)
    assert res.mse == pytest.approx(mse, rel=1e-6)
    assert res.mse > 0


def test_seg_metrics_golden():
    pred = np.array([0, 0, 1, 1, -1, 0], np.float32)
    gt = np.array([0, 1, 1, 0, 0, -1], np.float32)
    iou, prec, rec = tev.seg_metrics(pred, gt)
    assert iou == pytest.approx(1 / 3)
    assert prec == pytest.approx(1 / 2)
    assert rec == pytest.approx(1 / 2)
    assert tev.seg_metrics(pred, gt) == jev.seg_metrics(pred, gt)


def test_ground_truth_seg_classes():
    lab = np.array([40, 44, 48, 49, 60, 72, 10, 0, 1], np.uint32)
    seg = tev.ground_truth_seg(lab)
    np.testing.assert_array_equal(seg[:6], 0.0)
    assert seg[6] == 1.0
    np.testing.assert_array_equal(seg[7:], -1.0)
    np.testing.assert_array_equal(seg, jev.ground_truth_seg(lab))
    assert tev.GROUND_CLASSES == jev.GROUND_CLASSES
    assert tev.UNLABELED == jev.UNLABELED


# --- the port against JAX on the same weights and frames --------------------

def _assert_results_agree(got, want):
    assert got.frames == want.frames == FRAMES
    g, w = np.array(got.per_frame), np.array(want.per_frame)
    np.testing.assert_allclose(g[:, :3], w[:, :3], rtol=0, atol=METRIC_ATOL)
    np.testing.assert_allclose(g[:, 3], w[:, 3], rtol=MSE_RTOL)
    for k in ("iou", "precision", "recall"):
        assert getattr(got, k) == pytest.approx(getattr(want, k),
                                                abs=METRIC_ATOL)
    assert got.mse == pytest.approx(want.mse, rel=MSE_RTOL)


@pytest.mark.parametrize("impl,threshold", [
    ("affine", 0.0), ("affine", 0.08), ("affine", 0.16),
    ("scatter", 0.0), ("scatter", 0.16)])
def test_evaluate_semantic_kitti_matches_jax(weights, sequence, impl,
                                             threshold):
    """Both MSE conventions: the reference's (count + 1, unshifted z) and
    the corrected one."""
    sd, variables = weights
    jcfg, cfg = configs(impl)
    for compat in (True, False):
        want = jev.evaluate_semantic_kitti(jcfg, variables, str(sequence),
                                           threshold, compat)
        got = tev.evaluate_semantic_kitti(cfg, sd, str(sequence), threshold,
                                          compat, device="cpu")
        _assert_results_agree(got, want)
        assert 0 < got.iou < 1 and got.mse > 0


@pytest.mark.parametrize("impl", ["affine", "scatter"])
def test_evaluate_height_rmse_matches_jax(weights, sequence, tmp_path, impl):
    """On a dataset the port's generator writes from the sequence: one
    fused forward per batch of 2, the third frame's batch padded."""
    sd, variables = weights
    jcfg, cfg = configs(impl)
    out = tmp_path / "validation" / "seq_000"
    assert generate_sequence(str(sequence), str(out), cfg, seed=0,
                             device="cpu") == FRAMES
    want = jev.evaluate_height_rmse(jcfg, variables, str(tmp_path))
    got = tev.evaluate_height_rmse(cfg, sd, str(tmp_path), device="cpu")
    assert got["frames"] == want["frames"] == FRAMES
    np.testing.assert_allclose(got["per_frame"], want["per_frame"],
                               rtol=MSE_RTOL)
    assert got["rmse"] == pytest.approx(want["rmse"], rel=MSE_RTOL)


def test_evaluate_cli(weights, sequence, tmp_path, capsys):
    """`python -m gndnet_tpu_torch.scripts.evaluate` on a config file and
    a .pth.tar prints the harness's dict, and the same from a
    `CheckpointManager` directory holding those weights."""
    sd, _ = weights
    _, cfg = configs("affine")
    cfg_path, ckpt = tmp_path / "small.yaml", tmp_path / "w.pth.tar"
    cfg_path.write_text(yaml.safe_dump(
        {k: list(v) if isinstance(v, tuple) else v
         for k, v in dict(SMALL, fused_impl="affine").items()}))
    torch.save({"state_dict": sd, "epoch": 1}, ckpt)
    eval_cli.main(["--config", str(cfg_path), "--data_dir", str(sequence),
                   "--resume", str(ckpt), "--threshold", "0.08",
                   "--corrected", "--device", "cpu"])
    printed = ast.literal_eval(capsys.readouterr().out.strip())
    want = tev.evaluate_semantic_kitti(cfg, sd, str(sequence), 0.08, False,
                                       device="cpu").as_dict()
    assert printed == want
    ckpt_dir = tmp_path / "checkpoints"
    CheckpointManager(str(ckpt_dir)).save(
        3, {"state_dict": sd, "epoch": 3, "lowest_loss": 1.0,
            "optimizer": {}})
    eval_cli.main(["--config", str(cfg_path), "--data_dir", str(sequence),
                   "--resume", str(ckpt_dir), "--threshold", "0.08",
                   "--corrected", "--device", "cpu"])
    assert ast.literal_eval(capsys.readouterr().out.strip()) == want
