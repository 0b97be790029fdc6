"""Tensor parallelism: the output-channel sharding rule and a forward that
runs on it.

Counterpart of `gndnet_tpu.parallel.tp`.  At 2.2 M parameters GndNet does
not NEED tensor parallelism (activations, not weights, fill memory, and
dp x sp covers every shipped config), but the rule is part of the package:
shard the OUTPUT-channel axis of every conv / linear weight, bias and
BatchNorm vector across the tp ranks, and replicate whatever does not
divide.

The JAX package shards the LAST axis of each flax leaf (HWIO conv kernels,
(in, out) dense kernels, (C,) vectors).  A torch state dict holds the
output channel in dim 0 (Conv2d (O, I, kH, kW), Linear (out, in), (C,)
vectors), so the same rule on dim 0 shards the same leaves, by state-dict
name.

JAX hands the sharded variables to GSPMD, which inserts the collectives.
Here the forward is explicit (`make_tp_infer`): each rank computes its
output-channel slice of every conv and of the PFN linear, batch norm and
relu per channel, and all-gathers the channels where the next layer
contracts over them; the result equals the replicated forward.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from gndnet_tpu_torch.config import GndNetConfig
from gndnet_tpu_torch.models.gndnet import compute_dtype
from gndnet_tpu_torch.models.pfn import BN_EPS
from gndnet_tpu_torch.models.segnet import no_tf32
from gndnet_tpu_torch.ops.pooling import max_pool_argmax, max_unpool
from gndnet_tpu_torch.parallel import collectives as cc
from gndnet_tpu_torch.parallel.spatial import _fused_canvas

SEG_EPS = 1e-5


def make_tp_mesh(tp: int):
    """A 1-D ("tp",) mesh over every rank (one device a rank); raises
    unless tp ranks run."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size() if dist.is_initialized() else 1
    if tp != n:
        raise ValueError(f"tp={tp} needs {tp} ranks, have {n}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (tp,), mesh_dim_names=("tp",))


def _tp_size(mesh_or_size) -> int:
    return (mesh_or_size if isinstance(mesh_or_size, int)
            else mesh_or_size.size(0))


def tp_variable_specs(state_dict: dict, mesh_or_size) -> dict:
    """The rule: {name: 0 (sharded on the output-channel dim) or None
    (replicated)} for every tensor of `state_dict`.  A tensor is sharded
    when its dim 0 is at least tp and divides by it."""
    size = _tp_size(mesh_or_size)
    return {name: 0 if t.dim() >= 1 and t.shape[0] % size == 0
            and t.shape[0] >= size else None
            for name, t in state_dict.items()}


def tp_shard_variables(state_dict: dict, mesh) -> dict:
    """This rank's shard of `state_dict` under `tp_variable_specs`: the
    rank's contiguous slice of every sharded tensor, the others whole."""
    size, rank = _tp_size(mesh), mesh.get_local_rank("tp")
    specs = tp_variable_specs(state_dict, size)
    return {name: t.chunk(size, 0)[rank].clone() if specs[name] == 0
            else t for name, t in state_dict.items()}


def _gather_channels(x: torch.Tensor, full: int, group, dim: int):
    """All channels of `x` along `dim`: gathered over the tp ranks when
    this rank holds a slice."""
    return x if x.shape[dim] == full else cc.all_gather(x, group, dim)


def make_tp_infer(cfg: GndNetConfig, mesh) -> Callable:
    """(shards, points (B, N, F)) -> (B, ny, nx) on every tp rank, from
    this rank's `tp_shard_variables` of the model's state dict (fused path,
    one PFN layer, eval-mode batch norm).  The widths come from the
    shards: a conv's input channels (dim 1, never sharded) are the full
    width of the layer before it."""
    if len(cfg.vfe_filters) != 1:
        raise ValueError("the tp forward runs the fused path: one PFN layer")
    group = mesh.get_group("tp")
    dtype = compute_dtype(cfg)
    pfn = "voxel_feature_extractor.pfn_layers.0"
    enc = "encoder_decoder"

    def infer(shards, points):
        def fan_in(block):
            name = (f"{enc}.regressor" if block == "regressor"
                    else f"{enc}.{block}.conv1.cbr_unit.0")
            return shards[f"{name}.weight"].shape[1]

        def conv(x, prefix):
            w, b = shards[f"{prefix}.weight"], shards[f"{prefix}.bias"]
            return F.conv2d(x.to(dtype), w.to(dtype), b.to(dtype),
                            padding=1).float()

        def cbr(x, prefix, full_out):
            y = F.batch_norm(conv(x, f"{prefix}.0"),
                             shards[f"{prefix}.1.running_mean"],
                             shards[f"{prefix}.1.running_var"],
                             shards[f"{prefix}.1.weight"],
                             shards[f"{prefix}.1.bias"], False, 0.0, SEG_EPS)
            return _gather_channels(torch.relu(y), full_out, group, 1)

        def stage(x, block, next_block):
            """One SegNet block; its output gathered to the width that
            `next_block` contracts over."""
            p = f"{enc}.{block}"
            mid = shards[f"{p}.conv2.cbr_unit.0.weight"].shape[1]
            x = cbr(x, f"{p}.conv1.cbr_unit", mid)
            return cbr(x, f"{p}.conv2.cbr_unit", fan_in(next_block))

        dev = shards[f"{pfn}.linear.weight"].device
        points = torch.as_tensor(points, dtype=torch.float32, device=dev)
        with torch.no_grad():
            kernel = shards[f"{pfn}.linear.weight"].t()
            if cfg.use_norm:
                inv = (shards[f"{pfn}.norm.weight"] / torch.sqrt(
                    shards[f"{pfn}.norm.running_var"] + BN_EPS))
                kernel = kernel * inv[None, :]
                bias = (shards[f"{pfn}.norm.bias"]
                        - shards[f"{pfn}.norm.running_mean"] * inv)
            else:
                bias = shards[f"{pfn}.linear.bias"]
            canvas = _gather_channels(
                _fused_canvas(cfg, points, kernel, bias), fan_in("down1"),
                group, 3)
            full_f32 = (cfg.matmul_precision == "highest"
                        and dtype == torch.float32 and dev.type == "cuda")
            with no_tf32(full_f32):
                x = stage(canvas.permute(0, 3, 1, 2), "down1", "down2")
                hw1 = tuple(x.shape[-2:])
                x, idx1 = max_pool_argmax(x)
                x = stage(x, "down2", "up2")
                hw2 = tuple(x.shape[-2:])
                x, idx2 = max_pool_argmax(x)
                x = stage(max_unpool(x, idx2, hw2), "up2", "up1")
                x = stage(max_unpool(x, idx1, hw1), "up1", "regressor")
                # the one elevation channel: whole on every rank
                pred = conv(x, f"{enc}.regressor")
        return pred[:, 0]

    return infer
