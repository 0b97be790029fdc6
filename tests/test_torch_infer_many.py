"""Batched serving: the port's `GroundInferenceEngine.infer_many` against
the JAX engine's, on the 16x16 affine config of test_torch_infer.py
(float32, 'highest')."""

import numpy as np
import pytest
import torch

from gndnet_tpu.checkpoint import import_torch_state_dict
from gndnet_tpu.config import GndNetConfig as JaxConfig
from gndnet_tpu.infer import GroundInferenceEngine as JaxEngine
from gndnet_tpu_torch.config import GndNetConfig
from gndnet_tpu_torch.infer import GroundInferenceEngine
from gndnet_tpu_torch.ops.postproc import segment_cloud
from gndnet_tpu_torch.weights import init_state_dict
from test_torch_infer import SMALL, THRESHOLD, _labels_agree, scene

BUCKET = 1024


@pytest.fixture(scope="module")
def engines():
    """The port's seeded weights with random BN statistics in both
    engines (the JAX variables through the JAX package's importer)."""
    jcfg, cfg = JaxConfig(**SMALL), GndNetConfig(**SMALL)
    sd = init_state_dict(cfg, seed=0)
    rng = np.random.default_rng(0)
    for name, t in sd.items():
        if name.endswith("running_mean"):
            t.copy_(torch.from_numpy(rng.normal(0, 0.1, t.shape)))
        elif name.endswith("running_var"):
            t.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, t.shape)))
    return (JaxEngine(jcfg, import_torch_state_dict(sd, jcfg),
                      threshold=THRESHOLD, bucket=BUCKET),
            GroundInferenceEngine(cfg, sd, threshold=THRESHOLD,
                                  bucket=BUCKET, device="cpu"))


def _scans(seed, sizes):
    rng = np.random.default_rng(seed)
    return [scene(rng, n) for n in sizes]


@pytest.mark.parametrize("transfer_dtype", ["float32", "int16"])
def test_infer_many_matches_jax(engines, transfer_dtype):
    """Three scans of different lengths in one bucket: elevation to rtol
    1e-4 / atol 1e-5, labels equal away from the threshold, results in
    submission order and cut to each scan's length."""
    jeng, teng = engines
    if transfer_dtype != "float32":
        jeng = JaxEngine(jeng.cfg, jeng._variables, threshold=THRESHOLD,
                         bucket=BUCKET, transfer_dtype=transfer_dtype)
        teng = GroundInferenceEngine(teng.cfg, teng.model.state_dict(),
                                     threshold=THRESHOLD, bucket=BUCKET,
                                     transfer_dtype=transfer_dtype,
                                     device="cpu")
    scans = _scans(0, (600, 700, 900))
    want, got = jeng.infer_many(scans), teng.infer_many(scans)
    assert len(got) == 3
    for scan, (ej, lj), (et, lt) in zip(scans, want, got):
        assert et.shape == (16, 16) and et.dtype == np.float32
        assert lt.shape == (scan.shape[0],) and lt.dtype == np.int8
        np.testing.assert_allclose(et, ej, rtol=1e-4, atol=1e-5)
        _labels_agree(scan, ej, lj, lt, tol=1e-4)
    assert set(np.unique(got[0][1])) == {-1, 0, 1}


def test_infer_many_rejects_mixed_buckets(engines):
    scans = _scans(1, (600, 1500))
    for engine in engines:
        with pytest.raises(ValueError, match="mixed buckets"):
            engine.infer_many(scans)


def test_infer_many_of_one_scan_equals_infer(engines):
    _, teng = engines
    scan = _scans(2, (800,))[0]
    (elev, labels), = teng.infer_many([scan])
    e1, l1 = teng.infer(scan)
    np.testing.assert_array_equal(elev, e1)
    np.testing.assert_array_equal(labels, l1)


def test_infer_many_equals_per_scan_infer(engines):
    """B=3 in one call against three B=1 calls of the port: the canvases
    are equal (test_torch_train_canvas.py), the SegNet may convolve a
    batch in another order."""
    _, teng = engines
    scans = _scans(3, (500, 1000, 1024))
    for (eb, lb), scan in zip(teng.infer_many(scans), scans):
        e1, l1 = teng.infer(scan)
        np.testing.assert_allclose(eb, e1, rtol=1e-5, atol=1e-6)
        _labels_agree(scan, e1, l1, lb, tol=1e-5)


def test_run_many_reference_path_matches_kernel_path(engines):
    _, teng = engines
    prepared = [teng._prepare(s)[0] for s in _scans(4, (700, 900))]
    padded = torch.from_numpy(np.stack(prepared))
    e1, l1 = teng.run_many(padded)
    e2, l2 = teng.run_many(padded, reference=True)
    assert e1.shape == (2, 16, 16) and l1.shape == (2, BUCKET)
    assert l1.dtype == torch.int8
    assert torch.equal(e1, e2) and torch.equal(l1, l2)


def test_run_many_labels_in_one_batched_gather(engines):
    """run_many labels its K scans in one batched `segment_cloud` call,
    bit-equal to labelling each scan against its own map in a loop."""
    _, teng = engines
    prepared = [teng._prepare(s)[0] for s in _scans(5, (700, 900, 1000))]
    padded = torch.from_numpy(np.stack(prepared))
    elev, labels = teng.run_many(padded)
    pts = teng.device_points(padded)
    loop = torch.stack([
        segment_cloud(p, teng.cfg.grid_range, teng.cfg.voxel_size[0], e.t(),
                      teng.threshold) for p, e in zip(pts, elev)])
    assert torch.equal(labels, loop.to(torch.int8))
    assert set(labels.unique().tolist()) == {-1, 0, 1}
