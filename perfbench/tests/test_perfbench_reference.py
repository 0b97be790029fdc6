"""The plain reference against the program on the CPU at a tiny size: a
served scan's elevation map and labels, and three training steps."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from perfbench import cfg as cfgmod
from perfbench import reference, scenes, weights
from perfbench.tests.helpers import ROOT, bench
from perfbench.tests.cpu_run import tiny_config

HERE = os.path.join(ROOT, "perfbench")


def _setup(name: str):
    from gndnet_tpu_torch.config import GndNetConfig

    raw = cfgmod.read_json(os.path.join(HERE, "configs", name + ".json"))
    cfg, keys = cfgmod.load_config(name, HERE, tiny_config(name, raw))
    return cfg, GndNetConfig.from_dict(keys), weights.make(cfg, 5, "cpu")


@pytest.mark.parametrize("name", [c["name"] for c in bench()["configs"]])
def test_served_scan_matches_the_reference(name):
    """Every configuration of the benchmark at its CPU cut
    (`cpu_run.tiny_config`)."""
    from gndnet_tpu_torch.infer import GroundInferenceEngine

    cfg, pcfg, w = _setup(name)
    pts = scenes.scene(cfg.scene, cfg, np.random.default_rng(3),
                       cfg.num_points)
    engine = GroundInferenceEngine(pcfg, dict(w), threshold=0.08,
                                   device="cpu")
    got_map, got_lab = engine.infer(pts)
    with torch.no_grad():
        elev = reference.elevation(cfg, w, torch.from_numpy(pts)[None])[0]
        lab, margin = reference.labels(cfg, torch.from_numpy(pts), elev,
                                       0.08)
    scale = float(elev.abs().max())
    assert float((torch.from_numpy(got_map) - elev).abs().max()) \
        <= 1e-4 * scale
    sure = margin.abs() > 1e-3
    assert torch.equal(torch.from_numpy(got_lab)[sure], lab[sure])
    assert (lab == -1).any() and (lab == 1).any() and (lab == 0).any()


def test_training_steps_match_the_reference():
    from gndnet_tpu_torch import train

    cfg, pcfg, w = _setup("kitti_sem")
    pts, lab = scenes.labelled_batch(cfg.scene, cfg,
                                     np.random.default_rng(4), 6, 2000)
    pts[..., 2] += np.float32(cfg.lidar_height)
    lab += np.float32(cfg.lidar_height)
    batches = [(pts[i:i + 2], lab[i:i + 2]) for i in (0, 2, 4)]
    state = train.create_train_state(pcfg, steps_per_epoch=3,
                                     state_dict=dict(w), device="cpu")
    step = train.make_train_step(pcfg)
    losses = []
    for p, t in batches:
        state, loss = step(state, p, t)
        losses.append(float(loss))
    ref_losses, _, final = reference.sgd_steps(
        cfg, w, [(torch.from_numpy(p), torch.from_numpy(t))
                 for p, t in batches], cfg.lr)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    for n, p in state.model.named_parameters():
        moved = float((final[n] - w[n]).norm())
        assert abs(float((p.detach() - w[n]).norm()) - moved) \
            <= 1e-3 * max(moved, 1e-6), n
