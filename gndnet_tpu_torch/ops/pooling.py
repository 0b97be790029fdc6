"""2x2 max pool with indices and the index-routed unpool, NCHW.

Counterpart of `gndnet_tpu.ops.pooling`, which re-derives exactly the
reference's `MaxPool2d(2, return_indices=True)` / `MaxUnpool2d` pair
(reference modules/segnet.py:54-61, 84-92): floor division of odd sizes
(the trailing row/col never wins and unpool leaves it zero), the first
maximum of a window in row-major order, zeros away from the recorded
positions.  Here those are PyTorch's own ops, with one change to the
gradient: JAX differentiates the pool through `jnp.max`, which splits a
window's cotangent equally among its tied maxima (window [1, 1, 0.5, 1]
gives [1/3, 1/3, 0, 1/3]), where `F.max_pool2d` gives all of it to the
first.  `max_pool_argmax` splits as JAX does; ties are common in bf16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class _MaxPoolArgmax(torch.autograd.Function):
    """2x2 max pool whose backward shares a window's cotangent equally
    among the window's maxima (JAX's `jnp.max` gradient)."""

    @staticmethod
    def forward(ctx, x):
        pooled, idx = F.max_pool2d(x, kernel_size=2, stride=2,
                                   return_indices=True)
        ctx.save_for_backward(x, pooled)
        ctx.mark_non_differentiable(idx)
        return pooled, idx

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_pooled, _):
        x, pooled = ctx.saved_tensors
        b, c, h, w = pooled.shape
        win = x[:, :, :2 * h, :2 * w].reshape(b, c, h, 2, w, 2)
        hit = win == pooled[:, :, :, None, :, None]
        share = d_pooled / hit.sum(dim=(3, 5))
        dx = torch.zeros_like(x)
        dx[:, :, :2 * h, :2 * w] = (hit * share[:, :, :, None, :, None]
                                    ).reshape(b, c, 2 * h, 2 * w)
        return dx


def max_pool_argmax(x: torch.Tensor):
    """(B, C, H, W) -> (pooled (B, C, H//2, W//2), flat HW indices)."""
    return _MaxPoolArgmax.apply(x)


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
