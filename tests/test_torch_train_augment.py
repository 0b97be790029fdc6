"""Augmented training in the port: `make_train_step(augment=True)` is the
unaugmented step on the batch `apply_augment` gives (exactly, for fixed
draws), its draws are keyed on the step, and `train_and_evaluate(augment=
True)` trains on a generated dataset with unaugmented validation."""

import numpy as np
import pytest
import torch

from gndnet_tpu_torch import train
from gndnet_tpu_torch.config import AugmentationConfig, GndNetConfig
from gndnet_tpu_torch.data import augmentation as taug
from gndnet_tpu_torch.data.generator import generate_sequence
from gndnet_tpu_torch.data.provider import GroundDataset
from gndnet_tpu_torch.synthetic import (synthetic_semantic_kitti_scan,
                                        write_semantic_kitti_sequence)
from test_torch_train import SMALL, _labelled

AUG = AugmentationConfig(max_front_slope=5, max_side_tilt=5,
                         max_rotation=30, max_height=0.5)


def config(impl):
    return GndNetConfig(**SMALL).replace(fused_impl=impl, augmentation=AUG)


def params(state):
    return {k: v.detach().clone()
            for k, v in state.model.named_parameters()}


@pytest.mark.parametrize("impl", ["affine", "scatter"])
def test_augmented_step_equals_step_on_augmented_batch(impl, monkeypatch):
    """With the draws fixed, one augmented step gives the loss and the
    parameters of an unaugmented step on `apply_augment`'s batch, to the
    bit."""
    cfg = config(impl)
    pts, labels = _labelled(np.random.default_rng(0), cfg)
    ang = torch.tensor([[0.3, -0.05, 0.07], [-0.4, 0.06, -0.02]])
    dz = torch.tensor([0.25, -0.4])
    monkeypatch.setattr(taug, "augment_draws",
                        lambda gen, b, c: (ang[:b], dz[:b]))
    a = train.create_train_state(cfg, 10, device="cpu")
    b = train.create_train_state(cfg, 10, device="cpu")
    _, la = train.make_train_step(cfg, augment=True)(a, pts, labels)
    pa, lb_ = taug.apply_augment(torch.from_numpy(pts),
                                 torch.from_numpy(labels),
                                 taug.euler_zyx_matrices(ang), dz, cfg)
    assert not torch.equal(pa, torch.from_numpy(pts))
    _, lb = train.make_train_step(cfg)(b, pa, lb_)
    assert torch.equal(la, lb) and bool(torch.isfinite(la))
    pb = params(b)
    for k, v in params(a).items():
        assert torch.equal(v, pb[k]), k


def test_augmented_steps_are_keyed_on_the_step():
    """The same step draws the same: two runs from the same weights take
    identical steps; each step draws anew, and the augmented steps differ
    from unaugmented ones."""
    cfg = config("affine")
    pts, labels = _labelled(np.random.default_rng(1), cfg)
    runs = []
    for augment in (True, True, False):
        state = train.create_train_state(cfg, 10, device="cpu")
        step = train.make_train_step(cfg, augment=augment)
        runs.append([float(step(state, pts, labels)[1]) for _ in range(3)])
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]
    assert all(np.isfinite(runs[0]))
    draws = [taug.augment_draws(taug.augment_generator(
        train.AUGMENT_SEED, s, "cpu"), 2, cfg)[0] for s in (0, 1)]
    assert not torch.equal(*draws)


def test_train_and_evaluate_augmented(tmp_path):
    """One augmented epoch on training and validation splits the port's
    generator writes; the validation loss is the unaugmented eval step's
    over every validation frame."""
    cfg = config("affine").replace(num_points=600, max_memory=100.0,
                                   data_dir=str(tmp_path / "data"),
                                   lidar_height=1.7)
    rng = np.random.default_rng(2)
    for split, k in (("training", 4), ("validation", 3)):
        raw = tmp_path / "raw" / split
        write_semantic_kitti_sequence(
            str(raw), [synthetic_semantic_kitti_scan(cfg, rng, 1500)
                       for _ in range(k)])
        assert generate_sequence(str(raw), str(tmp_path / "data" / split /
                                               "seq_000"), cfg, seed=0,
                                 device="cpu") == k
    kw = dict(workdir=str(tmp_path / "run"), train_skip=1, valid_skip=1,
              print_freq=1, save_checkpoints=False, device="cpu")
    hist = train.train_and_evaluate(cfg, epochs=1, augment=True, **kw)
    plain = train.train_and_evaluate(cfg, epochs=1, **kw)
    assert hist["state"].step == 2 and len(hist["valid_loss"]) == 1
    assert np.isfinite(hist["train_loss"][0])
    assert hist["train_loss"] != plain["train_loss"]

    valid = GroundDataset(cfg.data_dir, "validation", 1, cfg.input_features)
    eval_step = train.make_eval_step(cfg)
    with torch.no_grad():
        losses = [float(eval_step(hist["state"], valid.data[i:i + 1],
                                  valid.labels[i:i + 1]))
                  for i in range(len(valid))]
    assert hist["valid_loss"][0] == pytest.approx(np.mean(losses), rel=1e-5)
