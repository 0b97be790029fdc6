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
the convs (cuDNN's default would use it).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from gndnet_tpu_torch.ops.pooling import max_pool_argmax, max_unpool


@contextlib.contextmanager
def _no_tf32(on: bool):
    if not on:
        yield
        return
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype):
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), conv.bias.to(dtype),
                    padding=1)


class ConvBNRelu(nn.Module):
    """conv2DBatchNormRelu (reference modules/segnet.py:11-44): 3x3 conv with
    bias + BatchNorm2d(eps 1e-5, momentum 0.1) + ReLU, as `cbr_unit`."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.cbr_unit = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=True),
            nn.BatchNorm2d(out_channels, eps=1e-5, momentum=0.1),
            nn.ReLU())

    def forward(self, x):
        conv, bn, relu = self.cbr_unit
        return relu(bn(_conv(conv, x, self.dtype).float()))


class SegnetDown2(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = ConvBNRelu(in_channels, out_channels, dtype)
        self.conv2 = ConvBNRelu(out_channels, out_channels, dtype)

    def forward(self, x):
        x = self.conv2(self.conv1(x))
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

    def forward(self, x, idx, out_hw):
        return self.conv2(self.conv1(max_unpool(x, idx, out_hw)))


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

    def forward(self, canvas: torch.Tensor) -> torch.Tensor:
        """canvas (B, ny, nx, C) -> (B, ny, nx, 1) float32."""
        full_f32 = (self.precision == "highest"
                    and self.dtype == torch.float32 and canvas.is_cuda)
        with _no_tf32(full_f32):
            x = canvas.permute(0, 3, 1, 2)
            down1, idx1, hw1 = self.down1(x)
            down2, idx2, hw2 = self.down2(down1)
            up2 = self.up2(down2, idx2, hw2)
            up1 = self.up1(up2, idx1, hw1)
            pred = _conv(self.regressor, up1, self.dtype)
        return pred.float().permute(0, 2, 3, 1)
