"""Parameters in the reference's state-dict names.

`state_dict_from_flax` maps the JAX package's flax variable tree (numpy
leaves) to a torch state dict named as the reference names it
(`voxel_feature_extractor.pfn_layers.0.linear.weight`,
`encoder_decoder.down1.conv1.cbr_unit.0.weight`, ...): the same mapping as
`gndnet_tpu.checkpoint.export_torch_state_dict`, with torch layouts
(Linear (out, in), Conv2d (O, I, kH, kW)).  `init_state_dict` makes random
weights from a numpy seed, for hosts without JAX.  `GroundEstimatorNet`'s
`load_state_dict` takes either unchanged.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from gndnet_tpu_torch.config import GndNetConfig

_SEG_STAGES = ("down1", "down2", "up2", "up1")
_SEG_CONVS = ("conv1", "conv2")
# (in, out) channels of every SegNet conv block, by stage
_SEG_WIDTHS = {"down1": ((None, 128), (128, 128)),
               "down2": ((128, 256), (256, 256)),
               "up2": ((256, 256), (256, 128)),
               "up1": ((128, 128), (128, 64))}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def state_dict_from_flax(variables_np: Mapping, cfg: GndNetConfig) -> dict:
    """flax variables {'params', 'batch_stats'} (numpy leaves) -> torch
    state dict in the reference's names."""
    params = variables_np["params"]
    stats = variables_np.get("batch_stats", {})
    sd: dict = {}
    for i in range(len(cfg.vfe_filters)):
        p = params["voxel_feature_extractor"][f"pfn_{i}"]
        dst = f"voxel_feature_extractor.pfn_layers.{i}"
        sd[f"{dst}.linear.weight"] = _t(np.asarray(p["linear"]["kernel"]).T)
        if "bias" in p["linear"]:
            sd[f"{dst}.linear.bias"] = _t(p["linear"]["bias"])
        if "norm" in p:
            s = stats["voxel_feature_extractor"][f"pfn_{i}"]["norm"]
            sd[f"{dst}.norm.weight"] = _t(p["norm"]["scale"])
            sd[f"{dst}.norm.bias"] = _t(p["norm"]["bias"])
            sd[f"{dst}.norm.running_mean"] = _t(s["mean"])
            sd[f"{dst}.norm.running_var"] = _t(s["var"])
    enc = params["encoder_decoder"]
    enc_s = stats.get("encoder_decoder", {})
    for stage in _SEG_STAGES:
        for conv in _SEG_CONVS:
            p = enc[stage][conv]
            s = enc_s[stage][conv]["bn"]
            dst = f"encoder_decoder.{stage}.{conv}.cbr_unit"
            sd[f"{dst}.0.weight"] = _t(
                np.asarray(p["conv"]["kernel"]).transpose(3, 2, 0, 1))
            sd[f"{dst}.0.bias"] = _t(p["conv"]["bias"])
            sd[f"{dst}.1.weight"] = _t(p["bn"]["scale"])
            sd[f"{dst}.1.bias"] = _t(p["bn"]["bias"])
            sd[f"{dst}.1.running_mean"] = _t(s["mean"])
            sd[f"{dst}.1.running_var"] = _t(s["var"])
    sd["encoder_decoder.regressor.weight"] = _t(
        np.asarray(enc["regressor"]["kernel"]).transpose(3, 2, 0, 1))
    sd["encoder_decoder.regressor.bias"] = _t(enc["regressor"]["bias"])
    return sd


def init_state_dict(cfg: GndNetConfig, seed: int = 0) -> dict:
    """Random weights from a numpy seed, in the reference's names: weights
    and biases uniform in +-1/sqrt(fan_in) (PyTorch's default Linear and
    Conv2d init), batch norm at scale 1, shift 0, mean 0, variance 1."""
    rng = np.random.default_rng(seed)
    sd: dict = {}

    def uniform(shape, fan_in):
        bound = 1.0 / np.sqrt(fan_in)
        return _t(rng.uniform(-bound, bound, shape))

    def norm(prefix, width):
        sd[f"{prefix}.weight"] = torch.ones(width)
        sd[f"{prefix}.bias"] = torch.zeros(width)
        sd[f"{prefix}.running_mean"] = torch.zeros(width)
        sd[f"{prefix}.running_var"] = torch.ones(width)

    widths = [cfg.num_decorated_features] + list(cfg.vfe_filters)
    for i in range(len(cfg.vfe_filters)):
        last = i == len(cfg.vfe_filters) - 1
        units = widths[i + 1] if last else widths[i + 1] // 2
        dst = f"voxel_feature_extractor.pfn_layers.{i}"
        sd[f"{dst}.linear.weight"] = uniform((units, widths[i]), widths[i])
        if cfg.use_norm:
            norm(f"{dst}.norm", units)
        else:
            sd[f"{dst}.linear.bias"] = uniform((units,), widths[i])
    for stage in _SEG_STAGES:
        for conv, (cin, cout) in zip(_SEG_CONVS, _SEG_WIDTHS[stage]):
            cin = cfg.vfe_filters[-1] if cin is None else cin
            dst = f"encoder_decoder.{stage}.{conv}.cbr_unit"
            sd[f"{dst}.0.weight"] = uniform((cout, cin, 3, 3), cin * 9)
            sd[f"{dst}.0.bias"] = uniform((cout,), cin * 9)
            norm(f"{dst}.1", cout)
    sd["encoder_decoder.regressor.weight"] = uniform((1, 64, 3, 3), 64 * 9)
    sd["encoder_decoder.regressor.bias"] = uniform((1,), 64 * 9)
    return sd
