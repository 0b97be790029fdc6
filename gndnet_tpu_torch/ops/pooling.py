"""2x2 max pool with indices and the index-routed unpool, NCHW.

Counterpart of `gndnet_tpu.ops.pooling`, which re-derives exactly the
reference's `MaxPool2d(2, return_indices=True)` / `MaxUnpool2d` pair
(reference modules/segnet.py:54-61, 84-92): floor division of odd sizes
(the trailing row/col never wins and unpool leaves it zero), the first
maximum of a window in row-major order, zeros away from the recorded
positions.  Here those are PyTorch's own ops.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool_argmax(x: torch.Tensor):
    """(B, C, H, W) -> (pooled (B, C, H//2, W//2), flat HW indices)."""
    return F.max_pool2d(x, kernel_size=2, stride=2, return_indices=True)


def max_unpool(pooled: torch.Tensor, idx: torch.Tensor,
               out_hw: tuple) -> torch.Tensor:
    """Inverse of `max_pool_argmax` onto an (H, W) = out_hw grid."""
    h, w = pooled.shape[-2:]
    oh, ow = out_hw
    if not (2 * h <= oh <= 2 * h + 1 and 2 * w <= ow <= 2 * w + 1):
        raise ValueError(f"output size {out_hw} incompatible with pooled "
                         f"{(h, w)}")
    return F.max_unpool2d(pooled, idx, kernel_size=2, stride=2,
                          output_size=(oh, ow))
