"""Weights bridge: JAX `init_model` variables load into the port under the
reference's state-dict names."""

import jax
import numpy as np
import pytest
import torch

from gndnet_tpu.checkpoint import export_torch_state_dict
from gndnet_tpu.config import GndNetConfig as JaxConfig
from gndnet_tpu.models.gndnet import init_model
from gndnet_tpu_torch.config import GndNetConfig
from gndnet_tpu_torch.models.gndnet import GroundEstimatorNet
from gndnet_tpu_torch.weights import init_state_dict, state_dict_from_flax

SMALL = dict(pc_range=(0.0, -8.0, -4.0, 16.0, 8.0, 4.0),
             grid_range=(0.0, -8.0, 16.0, 8.0), voxel_size=(1.0, 1.0, 8.0),
             max_points_voxel=20, max_voxels=256, input_features=4,
             num_points=512, lidar_height=1.7, fused_impl="affine")


@pytest.mark.parametrize("use_norm", [False, True])
def test_state_dict_from_flax_matches_export(use_norm):
    jcfg = JaxConfig(use_norm=use_norm, **SMALL)
    cfg = GndNetConfig(use_norm=use_norm, **SMALL)
    _, variables = init_model(jcfg, seed=3)
    variables_np = jax.tree_util.tree_map(np.asarray, variables)
    sd = state_dict_from_flax(variables_np, cfg)
    ref = export_torch_state_dict(variables_np, jcfg)
    assert sorted(sd) == sorted(ref)
    for name, want in ref.items():
        assert sd[name].dtype == torch.float32
        np.testing.assert_array_equal(sd[name].numpy(), want, err_msg=name)

    net = GroundEstimatorNet(cfg, device="cpu")
    net.load_state_dict(sd, strict=True)
    for name, value in net.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            assert torch.equal(value, sd[name]), name


@pytest.mark.parametrize("use_norm", [False, True])
def test_init_state_dict_names_and_shapes(use_norm):
    """The numpy-seeded weights carry exactly the names and shapes of the
    JAX model's exported state dict, and load strictly."""
    jcfg = JaxConfig(use_norm=use_norm, **SMALL)
    cfg = GndNetConfig(use_norm=use_norm, **SMALL)
    _, variables = init_model(jcfg)
    ref = export_torch_state_dict(
        jax.tree_util.tree_map(np.asarray, variables), jcfg)
    sd = init_state_dict(cfg, seed=0)
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: v.shape for k, v in ref.items()}
    GroundEstimatorNet(cfg, device="cpu").load_state_dict(sd, strict=True)
    again = init_state_dict(cfg, seed=0)
    other = init_state_dict(cfg, seed=1)
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert not torch.equal(sd["encoder_decoder.regressor.weight"],
                           other["encoder_decoder.regressor.weight"])


def test_effective_affine_folds_bn_like_jax():
    """With use_norm the eval-mode BN running stats fold into the PFN
    kernel and bias exactly as the JAX layer's `effective_affine`."""
    from gndnet_tpu.models.pfn import PFNLayer as JaxPFNLayer

    jcfg = JaxConfig(use_norm=True, **SMALL)
    cfg = GndNetConfig(use_norm=True, **SMALL)
    rng = np.random.default_rng(0)
    _, variables = init_model(jcfg)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    pfn_p = variables["params"]["voxel_feature_extractor"]["pfn_0"]
    pfn_s = variables["batch_stats"]["voxel_feature_extractor"]["pfn_0"]
    pfn_p["norm"]["scale"] = rng.uniform(0.5, 2, 64).astype(np.float32)
    pfn_p["norm"]["bias"] = rng.normal(size=64).astype(np.float32)
    pfn_s["norm"]["mean"] = rng.normal(size=64).astype(np.float32)
    pfn_s["norm"]["var"] = rng.uniform(0.5, 2, 64).astype(np.float32)

    layer = JaxPFNLayer(64, use_norm=True, last_layer=True)
    jk, jb = layer.apply({"params": pfn_p, "batch_stats": pfn_s},
                         method=JaxPFNLayer.effective_affine)
    net = GroundEstimatorNet(cfg, device="cpu")
    net.load_state_dict(state_dict_from_flax(variables, cfg))
    tk, tb = net.voxel_feature_extractor.pfn_layers[0].effective_affine()
    np.testing.assert_allclose(tk.detach().numpy(), np.asarray(jk),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tb.detach().numpy(), np.asarray(jb),
                               rtol=1e-6, atol=1e-7)
