"""SegNet and pooling of the port against the JAX `SegnetGndEst`, eval mode,
float32, on the 16x16 grid and an odd non-square grid (floor pooling)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gndnet_tpu.models.segnet import SegnetGndEst as JaxSegnet
from gndnet_tpu.ops.pooling import max_pool_argmax as jax_pool
from gndnet_tpu.ops.pooling import max_unpool as jax_unpool
from gndnet_tpu_torch.models.segnet import SegnetGndEst
from gndnet_tpu_torch.ops.pooling import max_pool_argmax, max_unpool
from gndnet_tpu_torch.weights import _SEG_CONVS, _SEG_STAGES


def _random_bn_stats(variables, rng):
    """Non-trivial running statistics and affine BN parameters."""
    params = variables["params"]
    for stage in _SEG_STAGES:
        for conv in _SEG_CONVS:
            bn = params[stage][conv]["bn"]
            n = bn["scale"].shape[0]
            bn["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            bn["bias"] = rng.normal(0, 0.1, n).astype(np.float32)
            st = variables["batch_stats"][stage][conv]["bn"]
            st["mean"] = rng.normal(0, 0.1, n).astype(np.float32)
            st["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return variables


def _torch_state(variables):
    """JAX SegNet variables -> the port's SegnetGndEst state dict (the
    `encoder_decoder.` sub-tree of `weights.state_dict_from_flax`)."""
    p, s = variables["params"], variables["batch_stats"]
    sd = {}
    for stage in _SEG_STAGES:
        for conv in _SEG_CONVS:
            src = p[stage][conv]
            dst = f"{stage}.{conv}.cbr_unit"
            sd[f"{dst}.0.weight"] = src["conv"]["kernel"].transpose(3, 2, 0, 1)
            sd[f"{dst}.0.bias"] = src["conv"]["bias"]
            sd[f"{dst}.1.weight"] = src["bn"]["scale"]
            sd[f"{dst}.1.bias"] = src["bn"]["bias"]
            sd[f"{dst}.1.running_mean"] = s[stage][conv]["bn"]["mean"]
            sd[f"{dst}.1.running_var"] = s[stage][conv]["bn"]["var"]
    sd["regressor.weight"] = p["regressor"]["kernel"].transpose(3, 2, 0, 1)
    sd["regressor.bias"] = p["regressor"]["bias"]
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


@pytest.mark.parametrize("ny,nx", [(16, 16), (10, 13)])
def test_segnet_matches_jax(ny, nx):
    rng = np.random.default_rng(7)
    canvas = np.maximum(rng.normal(size=(1, ny, nx, 64)), 0).astype(
        np.float32)
    jnet = JaxSegnet(in_channels=64)
    variables = jnet.init(jax.random.PRNGKey(0), jnp.asarray(canvas))
    variables = _random_bn_stats(
        jax.tree_util.tree_map(np.array, variables), rng)
    want = np.asarray(jnet.apply(variables, jnp.asarray(canvas)))

    net = SegnetGndEst(in_channels=64).eval()
    net.load_state_dict(_torch_state(variables), strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(canvas)).numpy()
    assert got.shape == want.shape == (1, ny, nx, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_segnet_bf16_runs_in_bf16_convs():
    """bf16 compute: convs in bf16, BN in f32, float32 output, close to the
    f32 result within bf16 noise."""
    rng = np.random.default_rng(1)
    canvas = torch.from_numpy(np.maximum(
        rng.normal(size=(1, 10, 13, 64)), 0).astype(np.float32))
    f32 = SegnetGndEst(in_channels=64).eval()
    bf16 = SegnetGndEst(in_channels=64, dtype=torch.bfloat16).eval()
    bf16.load_state_dict(f32.state_dict())
    with torch.no_grad():
        a, b = f32(canvas), bf16(canvas)
    assert b.dtype == torch.float32
    assert float((a - b).abs().max()) < 0.05 * float(a.abs().max()) + 0.05


@pytest.mark.parametrize("hw", [(8, 8), (9, 7), (13, 10), (5, 5)])
def test_pool_unpool_matches_jax(hw):
    h, w = hw
    rng = np.random.default_rng(h * w)
    x = rng.normal(size=(2, h, w, 3)).astype(np.float32)
    x[0, 0, 0] = x[0, 0, 1]          # a tie inside a window: first wins
    jp, ji = jax_pool(jnp.asarray(x))
    jr = jax_unpool(jp, ji, (h, w))
    tp, ti = max_pool_argmax(torch.from_numpy(x).permute(0, 3, 1, 2))
    tr = max_unpool(tp, ti, (h, w))
    np.testing.assert_array_equal(tp.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jp))
    np.testing.assert_array_equal(tr.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jr))


def test_unpool_rejects_wrong_size():
    p, i = max_pool_argmax(torch.zeros(1, 1, 6, 6))
    with pytest.raises(ValueError):
        max_unpool(p, i, (9, 6))
