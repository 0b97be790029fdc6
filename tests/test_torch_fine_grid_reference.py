"""The served scan against the benchmark's plain reference at the
benchmark's full grids, on the CPU: fine_grid's 250x250 cells of 0.4 m,
where a scan's packed (cell, index) key overflows 31 bits and the engine
sorts (cell, index) pairs (K10's branch of `pillarize.cell_stream`), and
kitti_sem's and camera's grids, where it does not.  The engine counts the
scans it served through that branch (`counts()["pair_sorted"]`)."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from gndnet_tpu_torch.ops import pillarize
from perfbench import cfg as cfgmod
from perfbench import reference, scenes, weights

HERE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "perfbench")


def test_pair_keys_is_the_packed_keys_overflow():
    """True exactly where num_cells_3d * idxcap + n - 1 passes 2^31 - 1,
    idxcap the power of two above n - 1."""
    assert pillarize.pair_keys(62_500, 102_400)        # fine_grid, served
    assert pillarize.pair_keys(62_500, 40_960)         # 62 500 * 2^16
    assert not pillarize.pair_keys(62_500, 32_768)     # 62 500 * 2^15
    assert not pillarize.pair_keys(10_000, 102_400)    # kitti_sem
    assert not pillarize.pair_keys(2_500, 12_288)      # camera
    # the drop id c3 with the last index is the largest key
    assert not pillarize.pair_keys(2**14 - 1, 2**17)
    assert pillarize.pair_keys(2**14, 2**17)


# (configuration, points a scan, scans that K10 sorts): 40 000 points pad to
# 40 960, so fine_grid's key reaches 62 500 * 2^16 + 40 959 >= 2^31
CASES = [("fine_grid", 40_000, 1), ("kitti_sem", 40_000, 0),
         ("camera", 10_000, 0)]


@pytest.mark.parametrize("name,points,pair_sorted", CASES)
def test_served_scan_matches_the_reference_at_the_full_grid(
        name, points, pair_sorted):
    """The canvas that the sorted stream feeds within 1e-5 of the
    reference canvas's largest magnitude (float32 re-association of the
    pillar net); the served map's 99th percentile gap within 1e-5 of the
    reference map's largest magnitude, since over 62 500 cells SegNet's
    2x2 argmax pools meet near-ties that a last bit of the canvas flips
    (a flip moves a few dozen cells by up to 1% of the map's scale); the
    labels equal wherever the reference's margin to the threshold exceeds
    1e-3, as the benchmark's own CPU check holds them."""
    from gndnet_tpu_torch.config import GndNetConfig
    from gndnet_tpu_torch.infer import GroundInferenceEngine

    cfg, keys = cfgmod.load_config(name, HERE)
    w = weights.make(cfg, 5, "cpu")
    pts = scenes.scene(cfg.scene, cfg, np.random.default_rng(3), points)
    engine = GroundInferenceEngine(GndNetConfig.from_dict(keys), dict(w),
                                   threshold=0.08, device="cpu")
    got_map, got_lab = engine.infer(pts)
    assert engine.counts()["pair_sorted"] == pair_sorted
    raw = torch.from_numpy(pts)
    with torch.no_grad():
        padded, _ = engine._prepare(pts)
        got_canvas = engine.model.canvas(
            engine.device_points(torch.from_numpy(padded))[None])[0]
        with reference.full_f32():
            canvas = reference.canvas(cfg, w, reference.shifted(cfg, raw))
        elev = reference.elevation(cfg, w, raw[None])[0]
        lab, margin = reference.labels(cfg, raw, elev, 0.08)
    assert float((got_canvas.permute(2, 0, 1) - canvas).abs().max()) \
        <= 1e-5 * float(canvas.abs().max())
    gap = (torch.from_numpy(got_map) - elev).abs()
    assert float(torch.quantile(gap.flatten(), 0.99)) \
        <= 1e-5 * float(elev.abs().max())
    sure = margin.abs() > 1e-3
    assert torch.equal(torch.from_numpy(got_lab)[sure], lab[sure])
    assert (lab == -1).any() and (lab == 1).any() and (lab == 0).any()
