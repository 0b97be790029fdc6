"""Loss functions: counterparts of `gndnet_tpu.losses` (the reference's
losses with identical math).

* `smooth_l1`: nn.SmoothL1Loss(beta=1, reduction='mean') as the live train
  loop uses it (reference training.py:102,157).
* `spatial_smooth_loss`: mean |second derivative| over dx2/dxdy/dydx/dy2 by
  nested finite differences (reference modules/loss_func.py:13-28).
* `masked_huber_loss`: mask-normalised SmoothL1 (reference
  modules/loss_func.py:34-44; unused by the reference's live loop).
* `total_loss`: alpha * smooth_l1 + beta * spatial_smooth (reference
  training.py:157, alpha 0.9, beta 0.1).
"""

from __future__ import annotations

import torch


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with `jnp.abs`'s gradient: +1 at x == 0 (torch's `abs` gives 0
    there, and a flat stretch of the elevation map has second differences
    of exactly 0)."""
    return torch.where(x >= 0, x, -x)


def _huber(d: torch.Tensor, beta: float) -> torch.Tensor:
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float = 1.0) -> torch.Tensor:
    """Elementwise SmoothL1 (Huber), mean reduction."""
    return _huber((pred - target).abs(), beta).mean()


def spatial_smooth_loss(pred_map: torch.Tensor) -> torch.Tensor:
    """Second-derivative smoothness of a (B, H, W) elevation map: axis 1 is
    y and axis 2 is x; each second difference is reduced by mean(|.|) over
    the spatial axes, then averaged over the batch."""
    def gradient(p):
        return p[:, :, 1:] - p[:, :, :-1], p[:, 1:] - p[:, :-1]

    dx, dy = gradient(pred_map)
    dx2, dxdy = gradient(dx)
    dydx, dy2 = gradient(dy)
    loss = sum(_abs(t).mean(dim=(1, 2)) for t in (dx2, dxdy, dydx, dy2))
    return loss.mean()


def masked_huber_loss(pred: torch.Tensor, target: torch.Tensor,
                      mask: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Per-sample sum of the masked SmoothL1 over its mask mass, then the
    batch mean."""
    el = _huber((pred * mask - target * mask).abs(), beta)
    return (el.sum(dim=(1, 2))
            / torch.clamp(mask.sum(dim=(1, 2)), min=1.0)).mean()


def total_loss(pred: torch.Tensor, labels: torch.Tensor, alpha: float = 0.9,
               beta: float = 0.1) -> torch.Tensor:
    """The live training objective (reference training.py:157)."""
    return alpha * smooth_l1(pred, labels) + beta * spatial_smooth_loss(pred)
