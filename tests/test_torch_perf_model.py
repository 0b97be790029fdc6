"""The port's `utils/perf_model.py` and `utils/profiling.py` against the
JAX package's on the CPU: the analytic model equal for every shipped
preset, the H100 rows from NVIDIA's datasheet, an unknown device kind
refused, and the timers and trace."""

import json

import pytest
import torch

import gndnet_tpu.config as jcfg
from gndnet_tpu.models.segnet import segnet_stage_shapes as jax_shapes
from gndnet_tpu.utils import perf_model as jpm
from gndnet_tpu_torch import config as tcfg
from gndnet_tpu_torch.models.segnet import segnet_stage_shapes
from gndnet_tpu_torch.utils import perf_model as pm
from gndnet_tpu_torch.utils.profiling import StageTimer, measure_hz, trace

TPU_KINDS = ("TPU v5 lite", "TPU v4", "TPU v5p", "TPU v6 lite")


@pytest.mark.parametrize("hw", [(100, 100, 64), (250, 250, 64),
                                (16, 16, 64), (10, 16, 32), (51, 7, 9)])
def test_segnet_stage_shapes_match_jax(hw):
    assert segnet_stage_shapes(*hw) == jax_shapes(*hw)


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_perf_model_matches_jax_for_every_preset(name):
    cfg, jc = tcfg.load_config(name), jcfg.load_config(name)
    assert pm.model_flops_per_scan(cfg) == jpm.model_flops_per_scan(jc)
    assert pm.train_flops_per_scan(cfg) == jpm.train_flops_per_scan(jc)
    assert pm.min_hbm_bytes_per_scan(cfg) == jpm.min_hbm_bytes_per_scan(jc)
    for kind in TPU_KINDS:
        assert pm.chip_peaks(kind) == jpm.chip_peaks(kind)
        for training in (False, True):
            assert (pm.perf_accounting(cfg, 250.0, 2, training, kind)
                    == jpm.perf_accounting(jc, 250.0, 2, training, kind))


@pytest.mark.parametrize("kind,flops,bps", [
    ("NVIDIA H100 80GB HBM3", 989.4e12, 3.35e12),
    ("NVIDIA H100 PCIe", 756e12, 2.0e12)])
def test_h100_rows_from_the_datasheet(kind, flops, bps):
    assert pm.chip_peaks(kind) == (flops, bps, kind)
    cfg = tcfg.kitti_sem_config()
    acc = pm.perf_accounting(cfg, hz=300.0, device_kind=kind)
    flops_scan = pm.model_flops_per_scan(cfg)
    assert acc["mfu_pct"] == pytest.approx(100 * 300 * flops_scan / flops,
                                           abs=0.01)
    assert acc["hbm_pct"] == pytest.approx(
        100 * 300 * pm.min_hbm_bytes_per_scan(cfg)["total"] / bps, abs=0.01)
    assert acc["chip"] == kind
    assert acc["peak_tflops_bf16"] == round(flops / 1e12, 0)


def test_unknown_device_kind_raises():
    """JAX scores an unknown kind against v5e's peaks; the port refuses."""
    assert jpm.chip_peaks("NVIDIA A100-SXM4-80GB")[:2] == (197e12, 819e9)
    for kind in ("NVIDIA A100-SXM4-80GB", "NVIDIA H100 NVL", "cpu"):
        with pytest.raises(ValueError, match="no datasheet peaks"):
            pm.chip_peaks(kind)
        with pytest.raises(ValueError, match="no datasheet peaks"):
            pm.perf_accounting(tcfg.kitti_sem_config(), 1.0,
                               device_kind=kind)


def test_kitti_flops_by_hand():
    """tests/test_accuracy_gate.py's count at kitti_sem on the port."""
    cfg = tcfg.kitti_sem_config()
    pfn = 2.0 * 100000 * 9 * 64
    seg = 18.0 * (100 * 100 * (64 * 128 + 128 * 128 + 128 * 128
                               + 128 * 64 + 64 * 1)
                  + 50 * 50 * (128 * 256 + 256 * 256 + 256 * 256
                               + 256 * 128))
    assert pm.model_flops_per_scan(cfg) == pytest.approx(pfn + seg)
    bts = pm.min_hbm_bytes_per_scan(cfg)
    assert bts["total"] == bts["frontend"] + bts["segnet"] + bts["postproc"]


def test_profiling_utils(tmp_path):
    """tests/test_infer_eval.py::test_profiling_utils on the port, and the
    trace file."""
    t = StageTimer()
    for name in ("a", "a", "b"):
        with t(name):
            pass
    rep = t.report()
    assert "a:" in rep and "over 2" in rep and "b:" in rep
    calls = []

    def fn(x):
        calls.append(1)
        return {"y": x * 2.0, "z": [x.sum()]}

    hz = measure_hz(fn, lambda: (torch.ones((64, 64)),), units_per_call=4,
                    reps=2)
    assert hz > 0 and len(calls) == 3     # one warm call, two reps
    with trace(str(tmp_path / "tb")):
        torch.ones(8).mul(3.0).sum()
    files = list((tmp_path / "tb").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::mul" in e.get("name", "") for e in events)
