"""Analytic FLOPs / bytes model and utilization accounting.

Counterpart of `gndnet_tpu.utils.perf_model`.  It prices one scan's
forward pass in the two currencies that transfer across hardware, matmul
FLOPs and device-memory bytes, so a measured rate can be reported as
achieved TFLOP/s, achieved GB/s and a share of the device's peaks.

Conventions (stated so the numbers can be audited):

* FLOPs count multiply-accumulates as 2 ops; only the two matmul-shaped
  stages are priced (the PFN linear and the 9-conv SegNet stack of
  `models.segnet.segnet_stage_shapes`).  Elementwise work (decoration,
  BN, relu, pooling, thresholding) adds under 1% and the sort is 0 FLOPs
  (comparisons).
* Bytes are a LOWER BOUND on device-memory traffic: each logical tensor
  crosses memory once per producer / consumer pair.  The sort keys are
  priced as one round-trip, the price of the work, whatever passes a
  given sort makes over them.
* Peaks are per-device datasheet numbers matched by substring against the
  device kind: `torch.cuda.get_device_name()` on a card, JAX's
  `device_kind` for the TPU rows, which are kept so that the same kind
  string gives the same dict in both packages.  They are the dense bf16
  matmul peak and the memory bandwidth.  float32 runs are scored against
  the bf16 peak too, so their MFU reads low by design.  An unknown kind
  raises: it is never scored against another device's peaks.
"""

from __future__ import annotations

# (dense bf16 peak FLOP/s, memory bytes/s) per device, matched by substring
# against the lower-cased kind.  TPU rows: public datasheets (v5e: 197
# bf16 TFLOP/s, 819 GB/s).  H100 rows: NVIDIA's H100 datasheet, dense
# (without sparsity) BF16 Tensor Core: SXM5 989.4 TFLOP/s, 3.35 TB/s HBM3
# ("NVIDIA H100 80GB HBM3"); PCIe 756 TFLOP/s, 2.0 TB/s.
_PEAKS = {
    "v5 lite": (197e12, 819e9),
    "v5e": (197e12, 819e9),
    "v4": (275e12, 1228e9),
    "v5p": (459e12, 2765e9),
    "v6": (918e12, 1640e9),
    "h100 pcie": (756e12, 2.0e12),
    "h100 80gb hbm3": (989.4e12, 3.35e12),
    "h100 sxm": (989.4e12, 3.35e12),
}


def chip_peaks(device_kind: str | None = None):
    """(peak_flops_per_s, peak_bytes_per_s, kind) for this device (default:
    the first CUDA card).  Raises ValueError for a kind with no row."""
    if device_kind is None:
        import torch

        device_kind = torch.cuda.get_device_name(0)
    kind_l = device_kind.lower()
    for key, peaks in _PEAKS.items():
        if key in kind_l:
            return peaks + (device_kind,)
    raise ValueError(
        f"no datasheet peaks for device kind {device_kind!r}; known: "
        f"{sorted(_PEAKS)}")


def model_flops_per_scan(cfg) -> float:
    """Matmul-shaped forward FLOPs for ONE scan (MACs x 2).

    PFN linear: num_points x decorated_features x C (the affine
    decomposition runs the same matmul on the raw stream).  SegNet: the
    9-conv stack at (ny, nx) per segnet_stage_shapes, 3x3 kernels, so
    9 x h x w x cin x cout MACs each."""
    from gndnet_tpu_torch.models.segnet import segnet_stage_shapes

    c = cfg.vfe_filters[-1]
    flops = 2.0 * cfg.num_points * cfg.num_decorated_features * c
    for h, w, cin, cout in segnet_stage_shapes(cfg.ny, cfg.nx, c):
        flops += 2.0 * 9.0 * h * w * cin * cout
    return flops


def min_hbm_bytes_per_scan(cfg) -> dict:
    """Lower bound on device-memory bytes for ONE served scan, itemized by
    stage (serving types: bf16 activations, f32 points and ids).

    frontend: raw points read (binning and the decoration gather read them
    twice), cell ids written, the packed sort keys one round-trip, the
    sorted decorated stream written and read by the scan, the canvas
    written.  segnet: every conv reads its input and writes its output once
    (BN / relu fused); the two pool index maps ride along (i32 at the
    pooled resolutions).  postproc: per-point elevation lookup and the
    label write."""
    from gndnet_tpu_torch.models.segnet import segnet_stage_shapes

    n = cfg.num_points
    f = cfg.input_features
    a = cfg.num_decorated_features
    c = cfg.vfe_filters[-1]
    act = 2                                   # bf16 activation bytes
    frontend = (
        4 * n * f          # points read for binning
        + 4 * n            # cell ids written
        + 2 * 4 * n        # packed sort keys: one round-trip
        + 4 * n * f        # points re-gathered for decoration
        + act * n * a      # decorated stream written
        + act * n * a      # ... read by the scan kernel
        + act * cfg.ny * cfg.nx * c   # canvas written
    )
    segnet = 0
    for h, w, cin, cout in segnet_stage_shapes(cfg.ny, cfg.nx, c):
        segnet += act * h * w * (cin + cout)
    segnet += 2 * 4 * (cfg.ny // 2) * (cfg.nx // 2) * 128
    segnet += 2 * 4 * (cfg.ny // 4) * (cfg.nx // 4) * 256
    post = 4 * n * 3 + 4 * cfg.ny * cfg.nx + n   # xyz read, map read, labels
    return {"frontend": frontend, "segnet": segnet, "postproc": post,
            "total": frontend + segnet + post}


def perf_accounting(cfg, hz: float, batch: int = 1,
                    training: bool = False,
                    device_kind: str | None = None) -> dict:
    """Utilization dict for a measured per-scan rate `hz`:
    gflops_per_scan, achieved_tflops, mfu_pct (against the device's bf16
    peak), min_bytes_per_scan and the implied achieved_gbps / hbm_pct.
    Both shares are UPPER bounds on how much of their resource is used:
    when both are low, the time goes elsewhere (launches, host work,
    serialization)."""
    peak_f, peak_b, kind = chip_peaks(device_kind)
    flops = (train_flops_per_scan if training else model_flops_per_scan)(cfg)
    bts = min_hbm_bytes_per_scan(cfg)
    if training:
        # backward re-reads activations and writes gradients: ~3x the
        # forward's minimum traffic (same convention as the FLOPs)
        bts = {k: 3 * v for k, v in bts.items()}
    return {
        "gflops_per_scan": round(flops / 1e9, 2),
        "achieved_tflops": round(hz * flops / 1e12, 2),
        "mfu_pct": round(100.0 * hz * flops / peak_f, 2),
        "min_bytes_per_scan": int(bts["total"]),
        "achieved_gbps": round(hz * bts["total"] / 1e9, 1),
        "hbm_pct": round(100.0 * hz * bts["total"] / peak_b, 2),
        "batch": batch,
        "chip": kind,
        "peak_tflops_bf16": round(peak_f / 1e12, 0),
        "peak_hbm_gbps": round(peak_b / 1e9, 0),
    }


def train_flops_per_scan(cfg) -> float:
    """Training-step FLOPs per scan: forward + backward.  The backward of
    a matmul / conv costs 2x the forward (d_input + d_weights), so
    fwd+bwd = 3x forward for the matmul-shaped stages."""
    return 3.0 * model_flops_per_scan(cfg)
