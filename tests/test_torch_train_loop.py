"""The port's training loop on the CPU: the plain path and the options
this slice does not carry, and `train_and_evaluate` with its checkpoints,
resumed, and read back by the JAX package."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gndnet_tpu.checkpoint import load_torch_checkpoint
from gndnet_tpu.config import GndNetConfig as JaxConfig
from gndnet_tpu.models.gndnet import GroundEstimatorNet as JaxNet
from gndnet_tpu_torch import train
from gndnet_tpu_torch.checkpoint import BEST, CHECKPOINT, restore_checkpoint
from gndnet_tpu_torch.config import GndNetConfig
from test_torch_train import SMALL, _labelled


def test_train_step_paths_and_errors():
    """The plain path (reference=True) takes the same steps as the kernel
    path's CPU run, augmentation and loss scaling run, and the options the
    port does not carry yet raise with their ROADMAP item."""
    cfg = GndNetConfig(**SMALL).replace(compute_dtype="bfloat16",
                                        matmul_precision="default")
    pts, labels = _labelled(np.random.default_rng(2), cfg)
    a = train.create_train_state(cfg, 10, device="cpu")
    b = train.create_train_state(cfg, 10, device="cpu")
    for _ in range(2):
        _, la = train.make_train_step(cfg)(a, pts, labels)
        _, lb = train.make_train_step(cfg, reference=True)(b, pts, labels)
        assert torch.equal(la, lb)
    # augmentation runs (test_torch_train_augment.py holds it)
    _, loss = train.make_train_step(cfg, augment=True)(a, pts, labels)
    assert bool(torch.isfinite(loss))
    # loss scaling runs (test_torch_train_pillar.py holds it against JAX)
    scaled = train.create_train_state(cfg, 10, loss_scaling=True,
                                      device="cpu")
    _, loss = train.make_train_step(cfg)(scaled, pts, labels)
    assert bool(torch.isfinite(loss)) and scaled.dynamic_scale.fin_steps == 1
    with pytest.raises(RuntimeError, match="process group of 2 ranks"):
        train.train_and_evaluate(cfg, dp=2, device="cpu")
    # use_norm training runs (through the scatter frontend, as JAX routes
    # it); test_torch_train_scatter.py holds it against JAX
    pred = train.create_train_state(cfg.replace(use_norm=True), 10,
                                    device="cpu").model.fused(
        torch.from_numpy(pts), train=True)
    assert pred.requires_grad and bool(torch.isfinite(pred).all())


# --- the epoch loop and checkpoints -----------------------------------------

def test_train_and_evaluate_checkpoint_and_resume(tmp_path):
    """train -> validate -> checkpoint (with a best copy) -> resume, on a
    tiny dataset as tests/test_train.py builds it; the checkpoint loads in
    the JAX package and gives the port's elevation there."""
    cfg = GndNetConfig(**SMALL).replace(num_points=600, max_memory=100.0,
                                        data_dir=str(tmp_path))
    rng = np.random.default_rng(8)
    for split, k in (("training", 4), ("validation", 2)):
        d = tmp_path / split / "seq_000"
        (d / "reduced_velo").mkdir(parents=True)
        (d / "gnd_labels").mkdir()
        for i in range(k):
            pts, labels = _labelled(rng, cfg, b=1)
            np.save(d / "reduced_velo" / f"{i:06d}.npy", pts[0])
            np.save(d / "gnd_labels" / f"{i:06d}.npy",
                    labels[0].astype(np.float64))
    run = tmp_path / "run"
    kw = dict(workdir=str(run), train_skip=1, valid_skip=1, print_freq=1,
              device="cpu")
    hist = train.train_and_evaluate(cfg, epochs=2, **kw)
    assert len(hist["train_loss"]) == 2 and np.isfinite(hist["lowest_loss"])
    ckpt = run / "checkpoints" / CHECKPOINT
    assert ckpt.exists() and (run / "checkpoints" / BEST).exists()

    # resume restores weights, statistics, momentum and the step count
    fresh = train.create_train_state(cfg, 2, seed=5, device="cpu")
    assert restore_checkpoint(str(ckpt), fresh)["epoch"] == 2
    live = hist["state"]
    assert fresh.step == live.step == 4
    for p, q in zip(fresh.tx.params, live.tx.params):
        assert torch.equal(p, q)
        assert torch.equal(fresh.tx.sgd.state[p]["momentum_buffer"],
                           live.tx.sgd.state[q]["momentum_buffer"])
    hist2 = train.train_and_evaluate(cfg, epochs=3, resume=True, **kw)
    assert len(hist2["train_loss"]) == 1 and hist2["state"].step == 6

    # the .pth.tar is the reference's dict: the JAX package reads it
    loaded = load_torch_checkpoint(str(ckpt), JaxConfig(**SMALL))
    assert loaded["epoch"] == 3
    assert loaded["lowest_loss"] == pytest.approx(hist2["lowest_loss"])
    pts, _ = _labelled(rng, cfg, b=1)
    want = JaxNet(JaxConfig(**SMALL)).apply(
        jax.tree_util.tree_map(jnp.asarray, loaded["variables"]),
        jnp.asarray(pts), method=JaxNet.fused)
    got = hist2["state"].model.fused(torch.from_numpy(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    assert os.path.exists(run / "training.log")
