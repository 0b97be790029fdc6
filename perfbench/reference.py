"""The plain reference of GndNet: scan -> elevation map -> per-point labels,
and one SGD training step, in plain PyTorch float32 with TF32 off.

Written from the published model (anshulpaigwar/GndNet: PointPillars'
pillar feature net, its `segnet.py` encoder-decoder, the `segment_cloud`
threshold of `utils.py`, `training.py`'s loss and SGD) and independent of
the code under test: it imports nothing of the program and takes only the
configuration, the weights the benchmark made and the raw points.  No
kernels, no cache, no batching beyond the training batch.

Its departures from the published code, each the program's documented
semantics:
- pillars are the grid's cells; each keeps its first `max_points_voxel`
  in-range points in scan order; the pillar's decorated rows are
  [p, xyz - the kept points' mean, xy - the cell centre]; a cell with
  fewer points than the cap has zero padding rows, so its max is floored
  at relu(bias); an empty cell's canvas row is 0 (the original's
  `max_voxels` never binds at these grids);
- batch norm trains on the batch's biased variance (as everywhere).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

SEGNET_BLOCKS = (("down1", ("conv1", "conv2")), ("down2", ("conv1", "conv2")),
                 ("up2", ("conv1", "conv2")), ("up1", ("conv1", "conv2")))
PFN = "voxel_feature_extractor.pfn_layers.0.linear"


@contextlib.contextmanager
def full_f32():
    """TF32 off for matmuls and convs inside the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def shifted(cfg, points: torch.Tensor, shift: bool = True) -> torch.Tensor:
    """The points the model sees: the first input_features columns, z
    lifted by the lidar height when `shift` and the configuration shifts
    the cloud (serving does; training takes its points as given)."""
    p = points[..., :cfg.input_features].float().clone()
    if shift and cfg.shift_cloud:
        p[..., 2] += cfg.lidar_height
    return p


def _bin(cfg, p: torch.Tensor):
    """(x cell, y cell, in range) of every point: floor((p - lo) / v) in
    float32, in range on all three axes."""
    cells, valid = [], None
    for k in range(3):
        v = torch.tensor(cfg.voxel_size[k], dtype=torch.float32,
                         device=p.device)
        c = torch.floor((p[:, k] - cfg.pc_range[k]) / v)
        extent = round((cfg.pc_range[3 + k] - cfg.pc_range[k])
                       / cfg.voxel_size[k])
        ok = (c >= 0) & (c < extent)
        valid = ok if valid is None else valid & ok
        cells.append(c)
    return cells[0].long(), cells[1].long(), valid


def pillar_rows(cfg, p: torch.Tensor):
    """One scan's kept points: (decorated rows (K, F + 5), their cells
    (K,), points per cell capped (ny * nx,))."""
    nx, ny = cfg.nx, cfg.ny
    cx, cy, valid = _bin(cfg, p)
    cell = torch.where(valid, cy * nx + cx, nx * ny)
    order = torch.argsort(cell, stable=True)
    sc = cell[order]
    pos = torch.arange(sc.numel(), device=p.device)
    first = torch.searchsorted(sc, sc, right=False)
    rank = torch.empty_like(pos)
    rank[order] = pos - first
    kept = valid & (rank < cfg.max_points_voxel)
    kc = cell[kept]
    kp = p[kept]
    count = torch.bincount(kc, minlength=nx * ny)
    sums = torch.zeros((nx * ny, 3), dtype=torch.float64, device=p.device)
    sums.index_add_(0, kc, kp[:, :3].double())
    mean = (sums / count.clamp(min=1)[:, None]).float()
    vx, vy = cfg.voxel_size[0], cfg.voxel_size[1]
    centre_x = (kc % nx).float() * vx + (vx / 2 + cfg.pc_range[0])
    centre_y = (kc // nx).float() * vy + (vy / 2 + cfg.pc_range[1])
    rows = torch.cat([kp, kp[:, :3] - mean[kc],
                      torch.stack([kp[:, 0] - centre_x,
                                   kp[:, 1] - centre_y], 1)], 1)
    return rows, kc, count


def canvas(cfg, w: dict, p: torch.Tensor) -> torch.Tensor:
    """One scan's (C, ny, nx) pseudo-image: per cell the max over its kept
    points of relu(rows @ W^T + b), floored at relu(b) where the cell has
    padding rows, 0 where it is empty.  Differentiable in W and b."""
    rows, kc, count = pillar_rows(cfg, p)
    weight, bias = w[PFN + ".weight"], w[PFN + ".bias"]
    acts = torch.relu(rows @ weight.t() + bias)
    c = acts.shape[1]
    ncell = cfg.nx * cfg.ny
    out = torch.zeros((ncell, c), dtype=acts.dtype, device=p.device)
    out = out.scatter_reduce(0, kc[:, None].expand(-1, c), acts, "amax",
                             include_self=False)
    padded = ((count > 0) & (count < cfg.max_points_voxel))[:, None]
    out = torch.where(padded, torch.maximum(out, torch.relu(bias)), out)
    out = torch.where((count > 0)[:, None], out, torch.zeros_like(out))
    return out.t().reshape(c, cfg.ny, cfg.nx)


def _cbr(w: dict, name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
    """3x3 conv with bias, batch norm (eps 1e-5), relu."""
    x = F.conv2d(x, w[name + ".0.weight"], w[name + ".0.bias"], padding=1)
    mean, var = ((None, None) if train else
                 (w[name + ".1.running_mean"], w[name + ".1.running_var"]))
    x = F.batch_norm(x, mean, var, w[name + ".1.weight"], w[name + ".1.bias"],
                     training=train, eps=1e-5)
    return torch.relu(x)


def segnet(w: dict, x: torch.Tensor, train: bool) -> torch.Tensor:
    """(B, C, ny, nx) canvas -> (B, ny, nx) elevation: two down stages
    (two conv blocks, 2x2 max pool with indices), two up stages (unpool,
    two conv blocks), a 3x3 regressor.  `train`: batch statistics."""
    skips = []
    for stage, convs in SEGNET_BLOCKS:
        pre = f"encoder_decoder.{stage}."
        if stage.startswith("up"):
            idx, hw = skips.pop()
            x = F.max_unpool2d(x, idx, 2, 2, output_size=hw)
        for conv in convs:
            x = _cbr(w, pre + conv + ".cbr_unit", x, train)
        if stage.startswith("down"):
            hw = x.shape[-2:]
            x, idx = F.max_pool2d(x, 2, 2, return_indices=True)
            skips.append((idx, hw))
    x = F.conv2d(x, w["encoder_decoder.regressor.weight"],
                 w["encoder_decoder.regressor.bias"], padding=1)
    return x[:, 0]


def elevation(cfg, w: dict, points: torch.Tensor,
              train: bool = False) -> torch.Tensor:
    """(B, N, >=F) raw points -> (B, ny, nx) elevation; `train`: with
    batch statistics, on points taken as given (a training batch comes in
    the model's frame)."""
    with full_f32():
        p = shifted(cfg, points, shift=not train)
        x = torch.stack([canvas(cfg, w, s) for s in p])
        return segnet(w, x, train)


def labels(cfg, points: torch.Tensor, elev: torch.Tensor,
           threshold: float):
    """(labels (N,) int8 {1 obstacle, 0 ground, -1 outside}, margin (N,)):
    a point is an obstacle when its lifted z lies more than `threshold`
    above the elevation of its grid_range cell; row and column 0 of that
    grid count as outside, as in the original.  `margin` is z - (elevation
    + threshold), 0 outside."""
    p = shifted(cfg, points)
    g0, g1 = cfg.grid_range[0], cfg.grid_range[1]
    cell = torch.tensor(cfg.voxel_size[0], dtype=torch.float32,
                        device=p.device)
    ix = torch.floor((p[:, 0] - g0) / cell).long()
    iy = torch.floor((p[:, 1] - g1) / cell).long()
    ny, nx = elev.shape
    inside = (ix > 0) & (ix < nx) & (iy > 0) & (iy < ny)
    e = elev[iy.clamp(0, ny - 1), ix.clamp(0, nx - 1)]
    margin = torch.where(inside, p[:, 2] - (e + threshold), 0.0)
    lab = torch.where(inside, (margin > 0).to(torch.int8),
                      torch.full_like(margin, -1, dtype=torch.int8))
    return lab, margin


def loss(cfg, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """alpha * SmoothL1(pred, target) + beta * mean |second differences|
    of the map (training.py, loss_func.py)."""
    huber = F.smooth_l1_loss(pred, target, beta=1.0)
    dx = pred[:, :, 1:] - pred[:, :, :-1]
    dy = pred[:, 1:] - pred[:, :-1]
    terms = (dx[:, :, 1:] - dx[:, :, :-1], dx[:, 1:] - dx[:, :-1],
             dy[:, :, 1:] - dy[:, :, :-1], dy[:, 1:] - dy[:, :-1])
    smooth = sum(t.abs().mean(dim=(1, 2)) for t in terms).mean()
    return cfg.alpha * huber + cfg.beta * smooth


def sgd_steps(cfg, w: dict, batches, lr: float):
    """SGD with momentum and weight decay, as `torch.optim.SGD` defines it,
    from the weights `w` (not changed) over `batches` [(points (B, N, F),
    target (B, ny, nx)), ...].  Returns (losses [float], the first step's
    gradient {name: tensor}, the final parameters {name: tensor});
    parameters are the tensors named `.weight` / `.bias` outside batch
    norm's running statistics."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in w.items()
              if not k.endswith(("running_mean", "running_var",
                                 "num_batches_tracked"))}
    stats = {k: v for k, v in w.items() if k not in params}
    opt = torch.optim.SGD(list(params.values()), lr=lr,
                          momentum=cfg.momentum,
                          weight_decay=cfg.weight_decay)
    losses, first = [], None
    for points, target in batches:
        opt.zero_grad()
        with full_f32():
            value = loss(cfg, elevation(cfg, {**params, **stats}, points,
                                        train=True), target)
            value.backward()
        if first is None:
            first = {k: p.grad.detach().clone() for k, p in params.items()}
        opt.step()
        losses.append(float(value.detach()))
    return losses, first, {k: p.detach() for k, p in params.items()}
