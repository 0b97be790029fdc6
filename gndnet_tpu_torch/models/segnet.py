"""SegNet-style conv encoder-decoder elevation regressor.

Counterpart of `gndnet_tpu.models.segnet` (reference modules/segnet.py:
11-142): two down stages of two Conv3x3+BatchNorm+ReLU blocks and an
argmax max pool, two up stages that unpool with the saved indices and apply
two conv blocks, and a 3x3 conv regressing one elevation channel.  NCHW
inside; the public boundary takes the JAX package's (B, ny, nx, C) canvas.

Convs run in `dtype` (bfloat16 or float32) with float32 parameters; batch
norm runs in float32 (eps 1e-5), as in the JAX package.  The convs are
PyTorch's (cuDNN on the card), as the JAX package left them to XLA.  With
float32 convs and precision 'highest' on the card, TF32 is switched off for
the convs (cuDNN's default would use it); a train step keeps it off through
its backward as well (`no_tf32`).

`forward(canvas, train)` takes flax's `train` flag, not the module's
training mode: with train=True batch norm normalises with the batch's
statistics and updates its running statistics as flax does (momentum 0.9,
the BIASED batch variance; `nn.BatchNorm2d` would store the unbiased one).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from gndnet_tpu_torch.ops.pooling import max_pool_argmax, max_unpool
from gndnet_tpu_torch.parallel.collectives import batch_moments


FLAX_BN_MOMENTUM = 0.9   # running = 0.9 * running + 0.1 * batch


@contextlib.contextmanager
def no_tf32(on: bool):
    """Full-f32 convs and matmuls inside the block when `on`."""
    if not on:
        yield
        return
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def segnet_stage_shapes(h: int, w: int, in_channels: int):
    """(h, w, cin, cout) of every conv in SegnetGndEst's 9-conv stack."""
    h2, w2 = -(-h // 2), -(-w // 2)
    return [(h, w, in_channels, 128), (h, w, 128, 128),
            (h2, w2, 128, 256), (h2, w2, 256, 256),
            (h2, w2, 256, 256), (h2, w2, 256, 128),
            (h, w, 128, 128), (h, w, 128, 64), (h, w, 64, 1)]


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype):
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), conv.bias.to(dtype),
                    padding=1)


def _update_running(bn: nn.BatchNorm2d, mean, var) -> None:
    """flax's running update with the batch's mean and biased variance."""
    with torch.no_grad():
        keep = FLAX_BN_MOMENTUM
        bn.running_mean.mul_(keep).add_(mean, alpha=1.0 - keep)
        bn.running_var.mul_(keep).add_(var, alpha=1.0 - keep)
        bn.num_batches_tracked.add_(1)


def _batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor, train: bool,
                group=None, keep: torch.Tensor | None = None):
    """flax `nn.BatchNorm` on NCHW float32: running statistics in eval;
    batch statistics in train, with the running update of flax.

    With a process `group` (the JAX package's `bn_axis`) the batch
    statistics are those of every rank's rows together (sync-BN:
    `parallel.collectives.batch_moments` sums the per-channel sums and the
    row counts over the group); `keep` marks the rows that count, the
    others being zero (the padded slabs of `parallel.spatial`)."""
    if not train:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps)
    if group is None and keep is None:
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        _update_running(bn, mean, var)
        return F.batch_norm(x, None, None, bn.weight, bn.bias, True, 0.0,
                            bn.eps)
    mean, var = batch_moments(x, (0, 2, 3), group, keep)
    _update_running(bn, mean.detach(), var.detach())
    inv = torch.rsqrt(var + bn.eps) * bn.weight
    return ((x - mean[None, :, None, None]) * inv[None, :, None, None]
            + bn.bias[None, :, None, None])


class ConvBNRelu(nn.Module):
    """conv2DBatchNormRelu (reference modules/segnet.py:11-44): 3x3 conv with
    bias + BatchNorm2d(eps 1e-5, momentum 0.1) + ReLU, as `cbr_unit`.
    `bn_group` (None: this process alone) is the process group of its
    training batch statistics."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.cbr_unit = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=True),
            nn.BatchNorm2d(out_channels, eps=1e-5, momentum=0.1),
            nn.ReLU())

    def forward(self, x, train: bool = False, bn_group=None):
        conv, bn, relu = self.cbr_unit
        return relu(_batch_norm(bn, _conv(conv, x, self.dtype).float(),
                                train, bn_group))


class SegnetDown2(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = ConvBNRelu(in_channels, out_channels, dtype)
        self.conv2 = ConvBNRelu(out_channels, out_channels, dtype)

    def forward(self, x, train: bool = False, bn_group=None):
        x = self.conv2(self.conv1(x, train, bn_group), train, bn_group)
        unpooled_hw = tuple(x.shape[-2:])
        pooled, idx = max_pool_argmax(x)
        return pooled, idx, unpooled_hw


class SegnetUp2(nn.Module):
    """Unpool, then conv1 keeping the width and conv2 to `out_channels`
    (reference modules/segnet.py:81-92)."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = ConvBNRelu(in_channels, in_channels, dtype)
        self.conv2 = ConvBNRelu(in_channels, out_channels, dtype)

    def forward(self, x, idx, out_hw, train: bool = False, bn_group=None):
        return self.conv2(self.conv1(max_unpool(x, idx, out_hw), train,
                                     bn_group), train, bn_group)


class SegnetGndEst(nn.Module):
    """The elevation head (reference modules/segnet.py:118-142):
    in->128 -> 128->256 -> unpool 256->128 -> unpool 128->64 -> 1."""

    def __init__(self, in_channels: int = 64,
                 dtype: torch.dtype = torch.float32,
                 precision: str = "highest"):
        super().__init__()
        self.dtype = dtype
        self.precision = precision
        self.down1 = SegnetDown2(in_channels, 128, dtype)
        self.down2 = SegnetDown2(128, 256, dtype)
        self.up2 = SegnetUp2(256, 128, dtype)
        self.up1 = SegnetUp2(128, 64, dtype)
        self.regressor = nn.Conv2d(64, 1, 3, padding=1, bias=True)

    def full_f32(self, device: torch.device) -> bool:
        """Whether TF32 must be off: float32 convs at 'highest' on the
        card."""
        return (self.precision == "highest" and self.dtype == torch.float32
                and device.type == "cuda")

    def forward(self, canvas: torch.Tensor, train: bool = False,
                bn_group=None) -> torch.Tensor:
        """canvas (B, ny, nx, C) -> (B, ny, nx, 1) float32; in training the
        batch statistics are taken over the ranks of `bn_group`."""
        with no_tf32(self.full_f32(canvas.device)):
            x = canvas.permute(0, 3, 1, 2)
            down1, idx1, hw1 = self.down1(x, train, bn_group)
            down2, idx2, hw2 = self.down2(down1, train, bn_group)
            up2 = self.up2(down2, idx2, hw2, train, bn_group)
            up1 = self.up1(up2, idx1, hw1, train, bn_group)
            pred = _conv(self.regressor, up1, self.dtype)
        return pred.float().permute(0, 2, 3, 1)
