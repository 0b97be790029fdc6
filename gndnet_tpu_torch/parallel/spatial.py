"""Spatial parallelism: the pseudo-image sharded over mesh dim "sp".

Counterpart of `gndnet_tpu.parallel.spatial`.  The conv-model analog of
sequence parallelism: the (ny, nx) pseudo-image height is split across the
sp ranks, each holding an hl-row slab.  Before every 3x3 conv a slab trades
one boundary row with each neighbour (`halo_exchange`, the JAX package's
`ppermute`), so the sharded SAME conv equals the unsharded one.  Pooling
and unpooling stay local, which needs hl divisible by 4 (two 2x2 pool
stages).  Any ny runs: `slab_height` rounds up and the trailing pad rows
are re-zeroed after every conv and left out of the batch statistics.

The SegNet here is a functional re-expression of `models.segnet` reading
the same module (parameters and running statistics), so spatial execution
shares checkpoints with the single-device model.  Tensors are NCHW inside;
slabs enter and leave in the JAX package's (B, hl, W, C) / (B, hl, W).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F

from gndnet_tpu_torch import train
from gndnet_tpu_torch.config import GndNetConfig
from gndnet_tpu_torch.models.gndnet import compute_dtype
from gndnet_tpu_torch.models.segnet import (SegnetGndEst, _batch_norm,
                                            no_tf32)
from gndnet_tpu_torch.ops import pillarize as pz
from gndnet_tpu_torch.ops.pooling import max_pool_argmax, max_unpool
from gndnet_tpu_torch.parallel import collectives as cc
from gndnet_tpu_torch.parallel import multihost
from gndnet_tpu_torch.parallel.mesh import _check_state, augment_local


class _Halo(torch.autograd.Function):
    """Forward: (B, C, hl, W) -> (B, C, hl + 2*halo, W) with `halo` rows of
    each neighbour (zeros at the image's edges), by one all_gather of every
    rank's 2*halo boundary rows within the group.  Backward: the transpose
    of that trade, each halo's cotangent added to the neighbour's boundary
    rows."""

    @staticmethod
    def forward(ctx, x, group, halo):
        ctx.group, ctx.halo = group, halo
        r, n = cc.rank(group), cc.size(group)
        parts = cc.gather_list(
            torch.cat([x[:, :, :halo], x[:, :, -halo:]], 2), group)
        zero = torch.zeros_like(x[:, :, :halo])
        prev = parts[r - 1][:, :, halo:] if r > 0 else zero
        nxt = parts[r + 1][:, :, :halo] if r < n - 1 else zero
        return _like(torch.cat([prev, x, nxt], 2), x)

    @staticmethod
    def backward(ctx, g):
        group, halo = ctx.group, ctx.halo
        r, n = cc.rank(group), cc.size(group)
        parts = cc.gather_list(
            torch.cat([g[:, :, :halo], g[:, :, -halo:]], 2), group)
        gx = g[:, :, halo:-halo].clone()
        if r < n - 1:     # our last rows were the next rank's prev halo
            gx[:, :, -halo:] += parts[r + 1][:, :, :halo]
        if r > 0:         # our first rows were the previous rank's next halo
            gx[:, :, :halo] += parts[r - 1][:, :, halo:]
        return gx, None, None


def _like(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """`y` in `x`'s memory layout.  The canvas enters the SegNet as a
    permuted NHWC tensor (channels-last strides), and a conv's rounding
    depends on its input's layout: a slab conv equals the unsharded one
    bit for bit only on the same layout."""
    if x.stride(1) == 1 and x.shape[1] > 1:      # channels innermost
        return y.contiguous(memory_format=torch.channels_last)
    return y


def halo_exchange(x: torch.Tensor, group, halo: int = 1) -> torch.Tensor:
    """Extend an NCHW (B, C, hl, W) slab with `halo` rows from each
    neighbour of the sp `group`; edge ranks receive zeros (the global SAME
    conv's zero padding).  The result keeps x's memory layout.
    Differentiable."""
    if cc.size(group) == 1:
        z = torch.zeros_like(x[:, :, :halo])
        return _like(torch.cat([z, x, z], 2), x)
    return _Halo.apply(x, group, halo)


def _conv3x3(x, weight, bias, dtype=torch.float32):
    """3x3 conv, H valid (the halo gives the context), W SAME, inputs and
    parameters in the compute dtype (flax `nn.Conv(dtype=...)`)."""
    return F.conv2d(x.to(dtype), weight.to(dtype), bias.to(dtype),
                    padding=(0, 1))


def _bn(x, bn, train: bool, group, keep=None):
    """flax BatchNorm in float32, training statistics synced over `group`
    (sync-BN: sums and row counts summed); `keep` marks the rows that
    count when padded rows were zeroed out of x."""
    return _batch_norm(bn, x.float(), train, group, keep)


def _cbr(x, block, train: bool, sp_group, bn_group, mask=None,
         dtype=torch.float32):
    """halo -> conv3x3 -> BN -> relu: one ConvBNRelu block, sharded.

    `mask(x)` re-zeroes globally out-of-range rows; it runs after the conv
    (so the batch statistics never see pad-row bias values) and after the
    relu (so the next conv's halo sees the global SAME zero padding)."""
    conv, bn, relu = block.cbr_unit
    y = _conv3x3(halo_exchange(x, sp_group), conv.weight, conv.bias, dtype)
    keep = None
    if mask is not None:
        y, keep = mask(y)
    y = relu(_bn(y, bn, train, bn_group, keep))
    if mask is not None:
        y, _ = mask(y)
    return y


def segnet_apply_spatial(encoder_decoder: SegnetGndEst, slab: torch.Tensor,
                         *, train: bool, sp_group, bn_group=None,
                         global_ny: int | None = None,
                         dtype=torch.float32) -> torch.Tensor:
    """Spatially sharded SegnetGndEst forward on this rank's (B, hl, W, C)
    slab -> (B, hl, W) float32.  Train mode normalises with statistics
    over `bn_group` and updates the module's running statistics in place
    (the same on every rank).

    Equal to the unsharded model when hl % 4 == 0 and hl * sp >= global_ny
    (default: == ny, an exact fit).  When global_ny < hl * sp (e.g. ny=250
    in 2 slabs of 128) the trailing pad rows are re-zeroed after every conv
    so the real rows see exactly the global SAME zero padding, pad rows
    never reach the batch statistics, and the pool / unpool floor-drop of
    odd heights matches the unsharded model (pooling windows stay aligned
    because every slab boundary is a multiple of 4)."""
    sp, sp_rank = cc.size(sp_group), cc.rank(sp_group)
    hl0 = slab.shape[1]
    if hl0 % 4 != 0:
        raise ValueError("slab height must be divisible by 4 (two pools)")
    if global_ny is None:
        global_ny = hl0 * sp
    if global_ny > hl0 * sp:
        raise ValueError(f"global_ny={global_ny} exceeds slab capacity "
                         f"{hl0}x{sp}")
    exact = global_ny == hl0 * sp

    def make_mask(gh: int):
        """Zero rows whose global index is >= gh; also return the mask of
        the rows that count for the batch statistics."""
        if exact:
            return None

        def mask(x):
            hl = x.shape[2]
            g = torch.arange(hl, device=x.device) + sp_rank * hl
            keep = (g < gh)[None, None, :, None]
            return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                                    device=x.device)), keep
        return mask

    def stage(x, block, mask):
        x = _cbr(x, block.conv1, train, sp_group, bn_group, mask, dtype)
        return _cbr(x, block.conv2, train, sp_group, bn_group, mask, dtype)

    def pre_pool(x, gh: int, mask):
        # the unsharded pool floor-drops the trailing odd row (never read);
        # here a pad row could pair with it in a window, so zero the
        # dropped row first: its unpooled position must come back as 0
        if mask is not None and gh % 2 == 1:
            hl = x.shape[2]
            g = torch.arange(hl, device=x.device) + sp_rank * hl
            x = torch.where((g < gh - 1)[None, None, :, None], x,
                            torch.zeros((), dtype=x.dtype, device=x.device))
        return x

    enc = encoder_decoder
    gh0 = global_ny
    gh1 = gh0 // 2
    m0, m1 = make_mask(gh0), make_mask(gh1)
    x = slab.permute(0, 3, 1, 2)
    x = stage(x, enc.down1, m0)
    hw1 = tuple(x.shape[-2:])
    x, idx1 = max_pool_argmax(pre_pool(x, gh0, m0))
    x = stage(x, enc.down2, m1)
    hw2 = tuple(x.shape[-2:])
    x, idx2 = max_pool_argmax(pre_pool(x, gh1, m1))
    x = stage(max_unpool(x, idx2, hw2), enc.up2, m1)
    x = stage(max_unpool(x, idx1, hw1), enc.up1, m0)
    reg = enc.regressor
    pred = _conv3x3(halo_exchange(x, sp_group), reg.weight, reg.bias, dtype)
    return pred[:, 0].float()


def _fused_canvas(cfg: GndNetConfig, points: torch.Tensor,
                  kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Fused (B, N, F) points -> (B, ny, nx, C) canvas from the PFN linear
    as (kernel (in, C), bias (C,)): the shard-local front half of
    `GroundEstimatorNet.fused` (use_norm must be False; callers check).

    Dispatches on cfg.fused_impl as the JAX package's `_fused_canvas` does:
    'affine' runs the port's kernel frontend (`ops.pillarize.affine_canvas`:
    K1 or K10, K3, K2 serving, K4 / K5 and K6 when autograd records), each
    dp shard sorting its own points; the other impls the scatter frontend.
    Differentiable in kernel and bias when autograd records."""
    geom = pz.PillarGeometry.from_config(cfg)
    ctx = pz.bin_points_batch(points, geom)
    flat = points.reshape(-1, points.shape[-1])
    cap = cfg.max_points_voxel
    if cfg.fused_impl == "affine":
        return pz.affine_canvas(
            flat, ctx, geom, cap, kernel, bias,
            with_distance=cfg.with_distance,
            exact_point_cap=cfg.exact_point_cap,
            compute_dtype=compute_dtype(cfg))
    decorated, kept, cell_count = pz.fused_frontend(
        flat, ctx, geom, cap, with_distance=cfg.with_distance,
        exact_point_cap=cfg.exact_point_cap)
    with no_tf32(cfg.matmul_precision == "highest"
                 and points.device.type == "cuda"):
        acts = torch.relu(decorated @ kernel + bias)
    return pz.canvas_from_activations(acts, ctx, kept, cell_count, geom, cap,
                                      pad_floor=torch.relu(bias))


def slab_height(ny: int, sp: int) -> int:
    """Smallest per-rank slab height that is a multiple of 4 (two pool
    stages) covering ny rows over sp ranks; hl * sp - ny trailing rows
    are zero padding, masked by segnet_apply_spatial."""
    return -(-ny // (4 * sp)) * 4


def _pad_canvas(canvas: torch.Tensor, hl: int, sp: int) -> torch.Tensor:
    pad = hl * sp - canvas.shape[1]
    if pad:
        canvas = F.pad(canvas, (0, 0, 0, 0, 0, pad))
    return canvas


def _slab_forward(cfg, model, points, sp_group, hl, train, bn_group=None,
                  precision=None):
    """Canvas (replicated over sp), this rank's slab, the sharded SegNet,
    then the all_gather of the slab predictions -> (B, ny, nx)."""
    sp, sp_rank = cc.size(sp_group), cc.rank(sp_group)
    kernel, bias = (model.voxel_feature_extractor.pfn_layers[0]
                    .effective_affine())
    canvas = _pad_canvas(_fused_canvas(cfg, points, kernel, bias), hl, sp)
    slab = canvas[:, sp_rank * hl:(sp_rank + 1) * hl]
    dtype = compute_dtype(cfg)
    full_f32 = ((precision or cfg.matmul_precision) == "highest"
                and dtype == torch.float32 and points.device.type == "cuda")
    with no_tf32(full_f32):
        pred = segnet_apply_spatial(
            model.encoder_decoder, slab, train=train, sp_group=sp_group,
            bn_group=bn_group, global_ny=cfg.ny, dtype=dtype)
    return cc.all_gather(pred, sp_group, 1)[:, :cfg.ny]


def _require_no_norm(cfg: GndNetConfig, what: str) -> None:
    if cfg.use_norm:
        raise ValueError(f"spatial {what} requires use_norm=False (fold BN "
                         "into the linear first)")


def make_spmd_train_step(cfg: GndNetConfig, mesh,
                         augment: bool = False) -> Callable:
    """Full dp x sp training step: (state, points, labels) -> (state,
    loss), this rank's dp shard in (the same on every sp rank of a dp row).

    Per rank: the fused canvas of the local dp shard (replicated over sp),
    this rank's slab, the spatially sharded SegNet with sync-BN over every
    rank, the all_gather of the slab predictions over sp, the loss on the
    full map.  Every sp rank computes the full loss; the all_gather's
    backward sums the sp ranks' cotangents, so a rank's gradient is sp
    times its slab's share: the gradients are averaged over sp, then over
    dp, and the loss over dp.  Requires use_norm=False; any ny runs.

    `augment=True` draws from (step, dp index), NOT the sp index: the sp
    ranks of a dp row must apply the same transform or their canvases
    diverge."""
    _require_no_norm(cfg, "training")
    sp_group, sp, _ = multihost.axis(mesh, "sp")
    dp_group, _, dp_index = multihost.axis(mesh, "dp")
    hl = slab_height(cfg.ny, sp)
    total = train.loss_fn(cfg)

    def step(state, points, labels):
        _check_state(state)
        points, labels = train._as_batch(state, points, labels)
        if augment:
            points, labels = augment_local(cfg, state, points, labels,
                                           dp_index)
        model = state.model
        with no_tf32(model.encoder_decoder.full_f32(model.device)):
            loss = total(_slab_forward(cfg, model, points, sp_group, hl,
                                       True, bn_group=dist.group.WORLD),
                         labels)
            state.tx.zero_grad()
            loss.backward()
        cc.pmean_grads_(state.tx.params, sp_group)
        cc.pmean_grads_(state.tx.params, dp_group)
        state.step += 1
        state.tx.step()
        return state, cc.all_reduce(loss.detach(), dp_group) / cc.size(
            dp_group)

    return step


def make_spatial_infer(cfg: GndNetConfig, mesh,
                       precision: str | None = None) -> Callable:
    """Eval-mode spatially sharded inference: (model, points (B/dp, N, F),
    this rank's dp shard) -> (B/dp, ny, nx), the same on every sp rank of
    a dp row.  `precision` overrides cfg.matmul_precision ('highest' keeps
    TF32 off for float32 convs on the card)."""
    _require_no_norm(cfg, "inference path")
    sp_group, sp, _ = multihost.axis(mesh, "sp")
    hl = slab_height(cfg.ny, sp)

    def infer(model, points):
        points = torch.as_tensor(points, dtype=torch.float32,
                                 device=model.device)
        with torch.no_grad():
            return _slab_forward(cfg, model, points, sp_group, hl, False,
                                 precision=precision)

    return infer
