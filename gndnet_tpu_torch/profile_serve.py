"""Where the time of one served kitti_sem scan goes, on the card.

    python -m gndnet_tpu_torch.profile_serve [--scans 30] [--out FILE]
        [--impl affine|scatter|sorted] [--shipped]

Serves synthetic 100 000-point scans through `GroundInferenceEngine` at the
serving settings (bf16 convs, 'default' precision; with --shipped, float32
and 'highest' as kitti_sem.yaml ships; random weights from a seed) and
prints JSON lines:
  * `stages`: mean milliseconds per scan of each stage, by CUDA events in
    one stream: host-to-device copy, shift, canvas (binning and the
    impl's frontend: K1 sort, row gather, K3 counts, K2 scan, epilogue for
    'affine'; argsort, K7 sums, PFN, K7 max for 'sorted'; rank sort,
    scatter-add, PFN, scatter-max for 'scatter'), SegNet, segmentation,
    and the device-to-host copy; plus the host-clock time of `infer()`;
  * `kernels`: device time per kernel name per scan over 10 profiled
    scans from `torch.profiler`, device operations per scan, and the device
    busy share of that window (kernel time over wall time), or "not
    measured" when the profiler records no device activity.
Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from gndnet_tpu_torch.config import kitti_sem_config
from gndnet_tpu_torch.infer import GroundInferenceEngine
from gndnet_tpu_torch.ops.postproc import segment_cloud
from gndnet_tpu_torch.synthetic import synthetic_scan
from gndnet_tpu_torch.weights import init_state_dict


def stage_times(engine, padded_scans) -> dict:
    """Mean ms per stage over the scans, CUDA events between stages."""
    names = ("h2d", "shift", "canvas", "segnet", "segment", "d2h")
    totals = dict.fromkeys(names, 0.0)
    model = engine.model
    for padded in padded_scans:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        with torch.no_grad():
            ev[0].record()
            raw = padded.to(engine.device, non_blocking=True)
            ev[1].record()
            pts = engine.device_points(raw)
            ev[2].record()
            canvas = model.canvas(pts[None])
            ev[3].record()
            pred = model.encoder_decoder(canvas)[0, ..., 0]
            ev[4].record()
            labels = segment_cloud(pts, engine.cfg.grid_range,
                                   engine.cfg.voxel_size[0], pred.t(),
                                   engine.threshold).to(torch.int8)
            ev[5].record()
            out = (pred.to("cpu", non_blocking=True),
                   labels.to("cpu", non_blocking=True))
            ev[6].record()
        torch.cuda.synchronize()
        del out
        for i, name in enumerate(names):
            totals[name] += ev[i].elapsed_time(ev[i + 1])
    return {k: v / len(padded_scans) for k, v in totals.items()}


def kernel_times(fn, reps: int) -> dict:
    """`torch.profiler` over `reps` calls of fn(): device time per kernel
    name and per call, kernel launches per call, and the device busy share
    of the window (kernel time over wall time), or "not measured" when the
    profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        dev = getattr(evt, "self_device_time_total", 0.0) or 0.0
        if dev > 0 and evt.device_type.name == "CUDA":
            rows.append((evt.key, dev / 1e3 / reps, evt.count))
    rows.sort(key=lambda r: -r[1])
    if not rows:
        return {"device_busy_share": "not measured",
                "per_call_ms": "not measured"}
    busy = sum(r[1] for r in rows) * reps
    return {"wall_ms_per_call": wall_ms / reps,
            "device_ms_per_call": busy / reps,
            "device_busy_share": busy / wall_ms,
            "device_ops_per_call": sum(r[2] for r in rows) / reps,
            "top": [{"kernel": k[:120], "ms_per_call": ms,
                     "calls_per_call": c / reps}
                    for k, ms, c in rows[:25]]}


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def write_lines(lines, out) -> None:
    for line in lines:
        print(json.dumps(line), flush=True)
    if out:
        with open(out, "w") as f:
            f.writelines(json.dumps(line) + "\n" for line in lines)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scans", type=int, default=30)
    ap.add_argument("--out", default=None,
                    help="also write the JSON lines to this file")
    ap.add_argument("--impl", default="affine",
                    choices=("affine", "scatter", "sorted"))
    ap.add_argument("--shipped", action="store_true",
                    help="float32 and 'highest', as kitti_sem.yaml ships")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    smi = card()
    cfg = kitti_sem_config().replace(fused_impl=args.impl)
    if not args.shipped:
        cfg = cfg.replace(compute_dtype="bfloat16",
                          matmul_precision="default")
    engine = GroundInferenceEngine(cfg, init_state_dict(cfg, seed=0))
    rng = np.random.default_rng(0)
    scans = [synthetic_scan(cfg, rng) for _ in range(args.scans)]
    engine.warmup()

    t0 = time.perf_counter()
    for s in scans:
        engine.infer(s)
    infer_ms = (time.perf_counter() - t0) * 1e3 / len(scans)
    padded = [torch.from_numpy(engine._prepare(s)[0]).pin_memory()
              for s in scans]
    stage_times(engine, padded[:3])                     # warm
    profiled = iter(scans[:10])
    lines = [
        {"card": smi, "torch": torch.__version__, "scans": len(scans),
         "fused_impl": cfg.fused_impl, "compute_dtype": cfg.compute_dtype,
         "matmul_precision": cfg.matmul_precision},
        {"stages_ms": stage_times(engine, padded),
         "infer_ms_host_clock": infer_ms,
         "scans_per_s_host_clock": 1e3 / infer_ms},
        {"kernels": kernel_times(lambda: engine.infer(next(profiled)),
                                 10)},
    ]
    write_lines(lines, args.out)


if __name__ == "__main__":
    main()
