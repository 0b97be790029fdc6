"""The benchmark's arithmetic: the card's peaks, a scan's model FLOPs, and
the least bytes and operations of each hand-written kernel's call.

Frozen copies, kept here so that the program cannot move them: the FLOP
count is `gndnet_tpu_torch/utils/perf_model.py`'s (the PFN linear and the
nine SegNet convolutions, a multiply-add counted as 2; elementwise work
adds under 1%), at the shapes the model runs (2x2 pools floor odd sizes);
the kernels' bytes and operations are those of `chip_smoke.py`'s bounds
(PERF.md's kernel table, "bound ms"): each input byte read once, each
output byte written once, counted for what these inputs need.  The
kernels: K1 (the packed-key sort), K10 (the (cell, index) pair sort of a
grid whose packed key overflows 31 bits), K3, K2, K4 and K6.

Peaks (NVIDIA H100 SXM data sheet, dense): float32 outside the tensor
cores 67 TFLOP/s, which is the peak of these configurations (float32 with
TF32 off), and 3.35 TB/s of HBM3, both at the full 700 W.
"""

from __future__ import annotations

import numpy as np

F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
CARD = "H100"


def segnet_convs(cfg) -> list:
    """(h, w, cin, cout) of the nine SegNet convolutions as they run."""
    h, w = cfg.ny, cfg.nx
    h2, w2 = h // 2, w // 2
    c = cfg.vfe_filters[-1]
    return [(h, w, c, 128), (h, w, 128, 128),
            (h2, w2, 128, 256), (h2, w2, 256, 256),
            (h2, w2, 256, 256), (h2, w2, 256, 128),
            (h, w, 128, 128), (h, w, 128, 64), (h, w, 64, 1)]


def forward_flops(cfg, n_points: int) -> float:
    """Model FLOPs of one scan's forward pass."""
    c = cfg.vfe_filters[-1]
    flops = 2.0 * n_points * (cfg.input_features + 5) * c
    for h, w, cin, cout in segnet_convs(cfg):
        flops += 2.0 * 9.0 * h * w * cin * cout
    return flops


def train_flops(cfg, n_points: int) -> float:
    """Model FLOPs of one trained scan: the backward of a matmul or a
    convolution costs twice its forward."""
    return 3.0 * forward_flops(cfg, n_points)


def scan_cells(cfg, points: np.ndarray) -> tuple:
    """(kept points, occupied cells) of one raw scan: points in the
    pc_range box after the lidar-height lift, at most max_points_voxel a
    cell."""
    p = points[:, :3].astype(np.float32)
    if cfg.shift_cloud:
        p[:, 2] += np.float32(cfg.lidar_height)
    valid = np.ones(len(p), bool)
    cells = []
    for k in range(3):
        c = np.floor((p[:, k] - np.float32(cfg.pc_range[k]))
                     / np.float32(cfg.voxel_size[k]))
        extent = round((cfg.pc_range[3 + k] - cfg.pc_range[k])
                       / cfg.voxel_size[k])
        valid &= (c >= 0) & (c < extent)
        cells.append(c)
    cell = (cells[1][valid] * cfg.nx + cells[0][valid]).astype(np.int64)
    count = np.bincount(cell, minlength=cfg.num_cells)
    return (int(np.minimum(count, cfg.max_points_voxel).sum()),
            int((count > 0).sum()))


def kernel_work(kernel: str, shape: dict) -> tuple:
    """(bytes, operations) of one call of `kernel` at `shape`: batch (scans
    a call), padded (points a scan as the call gets them), cells (grid
    cells a scan), kept and occupied (a scan's, averaged over its traffic),
    features (a point's columns), width (PFN channels), out_bytes (the
    compute type's size)."""
    b, n = shape["batch"], shape["padded"]
    nc = b * shape["cells"]
    kept, occ = b * shape["kept"], b * shape["occupied"]
    a, width, ob = shape["features"], shape["width"], shape["out_bytes"]
    scan = (4 * kept * a + 2 * 4 * nc + 4 * a * width + 4 * 4 * nc,
            kept * (2 * a * width + 3))
    if kernel == "K1":        # sort of one packed key a point: a round trip
        return 2 * 4 * b * n, 0
    if kernel == "K10":       # sort of (cell, index) int32 pairs: a round trip
        return 2 * 2 * 4 * b * n, 0
    if kernel == "K3":        # ids read, per-cell ends and counts written
        return 4 * b * n + 2 * 4 * nc, b * n
    if kernel == "K2":        # kept rows, runs, the matrix; sums and max out
        return scan[0] + ob * nc * width, scan[1]
    if kernel == "K4":        # as K2, with each max's row index out
        return scan[0] + (ob + 4) * nc * width, scan[1]
    if kernel == "K6":        # occupied cells' gradient and argmax rows in
        return ((ob + 4) * occ * width + 4 * nc + 4 * a * width,
                2 * a * occ * width)
    raise ValueError(f"no work model for kernel {kernel!r}")


def least_seconds(bytes_moved: float, ops: float) -> float:
    """The least time of a call: bytes at the HBM rate or float32
    operations at the peak, whichever is longer."""
    return max(bytes_moved / HBM_BYTES_PER_S, ops / F32_FLOPS)
