"""Training of the port against the JAX package on the CPU: three fused
train steps from the same initial variables (the parts are in
test_torch_train_parts.py, the epoch loop in test_torch_train_loop.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gndnet_tpu import train as jtrain
from gndnet_tpu.config import GndNetConfig as JaxConfig
from gndnet_tpu_torch import train
from gndnet_tpu_torch.config import GndNetConfig
from gndnet_tpu_torch.weights import state_dict_from_flax

# tests/test_train.py's configuration, on the affine path
SMALL = dict(pc_range=(0.0, -8.0, -4.0, 16.0, 8.0, 4.0),
             grid_range=(0.0, -8.0, 16.0, 8.0), voxel_size=(1.0, 1.0, 8.0),
             max_points_voxel=20, max_voxels=256, input_features=4,
             batch_size=2, use_norm=False, lr=0.05, fused_impl="affine")


def _labelled(rng, cfg, b=2, n=600):
    """tests/test_train.py's batch: a sloped plane and its heights."""
    pts = np.zeros((b, n, cfg.input_features), np.float32)
    x = rng.uniform(cfg.pc_range[0], cfg.pc_range[3], (b, n))
    y = rng.uniform(cfg.pc_range[1], cfg.pc_range[4], (b, n))
    pts[..., 0], pts[..., 1] = x, y
    pts[..., 2] = 0.05 * x - 0.5 + rng.normal(0, 0.02, (b, n))
    xs = np.arange(cfg.nx) * cfg.voxel_size[0] + cfg.pc_range[0] + 0.5
    labels = np.broadcast_to((0.05 * xs - 0.5)[None, None, :],
                             (b, cfg.ny, cfg.nx)).astype(np.float32)
    return pts, labels


def _close_to_scale(got, want, share, what="", floor=1e-12):
    scale = max(float(np.abs(want).max()), floor)
    np.testing.assert_allclose(got, want, rtol=0, atol=share * scale,
                               err_msg=what)


# --- the train step ---------------------------------------------------------

def test_three_train_steps_match_jax():
    """make_train_step at float32 / 'highest' from JAX's initial variables
    (through `weights.state_dict_from_flax`): loss within rel 1e-5 at every
    step; after three steps every parameter and batch-norm statistic
    within 1e-4 of its tensor's largest magnitude.  That magnitude is
    floored at 1e-4: a conv bias that feeds batch norm has an exact
    gradient of zero, so its values (about 1e-9 here) are rounding noise
    of either side."""
    jcfg, cfg = JaxConfig(**SMALL), GndNetConfig(**SMALL)
    pts, labels = _labelled(np.random.default_rng(1234), cfg)
    model, tx, state = jtrain.create_train_state(jcfg, steps_per_epoch=10)
    initial = jax.tree_util.tree_map(np.array, {
        "params": state.params, "batch_stats": state.batch_stats})
    jstep = jtrain.make_train_step(model, tx, jcfg)
    tstate = train.create_train_state(
        cfg, 10, state_dict=state_dict_from_flax(initial, cfg), device="cpu")
    tstep = train.make_train_step(cfg)
    for i in range(3):
        state, jloss = jstep(state, jnp.asarray(pts), jnp.asarray(labels))
        tstate, tloss = tstep(tstate, pts, labels)
        assert float(tloss) == pytest.approx(float(jloss), rel=1e-5), i
    assert tstate.step == 3
    final = jax.tree_util.tree_map(np.array, {
        "params": state.params, "batch_stats": state.batch_stats})
    want = state_dict_from_flax(final, cfg)
    got = tstate.model.state_dict()
    for name, w in want.items():
        _close_to_scale(got[name].numpy(), w.numpy(), 1e-4, name,
                        floor=1e-4)
