#!/usr/bin/env python3
"""Card smoke test of gndnet_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each printing one JSON line:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile every kernel of csrc/ with nvcc;
  3. kernels: each hand-written kernel (K1 sort, K3 cell counts, K2 capped
     scan at the serving shapes; K4 and K5 argmax scans and K6 d(mmat) at
     the kitti_sem B=2 training shapes) against its plain PyTorch version
     on the card, with edge cases, its time, the plain version's time and
     a library call's time (CUDA events over warm repetitions);
  4. serve: kitti_sem single-scan serving (bf16 convs, 'default' precision,
     random weights from a seed) of synthetic 100 000-point scans through
     GroundInferenceEngine on the card; K1-K3 must launch and K4-K6 not,
     elevations must be finite and labels in {-1, 0, 1};
  5. parity: the same engine at float32 / 'highest' with TF32 off, kernel
     path against the plain path on the card;
  6. train: kitti_sem training at B=2 (bf16, 'default', affine) on
     synthetic labelled scans through make_train_step: K3, K5 and K6 must
     launch and K2 not, the loss must stay finite and every parameter
     move; steps/s at B=2 and at B=16 (bench.py's train batch);
  7. train_parity: three float32 / 'highest' train steps with TF32 off,
     kernel path (K4, K6) against the plain path;
  8. the kernels line, then the result line.
Any failed check raises, so the exit code is non-zero and no result line
is printed.  Without a CUDA device the script exits with code 2.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from gndnet_tpu_torch import _ext, train
from gndnet_tpu_torch.config import kitti_sem_config
from gndnet_tpu_torch.infer import GroundInferenceEngine
from gndnet_tpu_torch.ops import affine, sort
from gndnet_tpu_torch.ops import pillarize as pz
from gndnet_tpu_torch.ops.postproc import _cell_indices
from gndnet_tpu_torch.synthetic import synthetic_labelled_batch, synthetic_scan
from gndnet_tpu_torch.weights import init_state_dict

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12          # CUDA-core float32, H100 SXM data sheet
SEED = 0
TRAIN_BATCH = 2          # kitti_sem.yaml's batch_size
BENCH_BATCH = 16         # bench.py's train batch
DMMAT_RTOL = 1e-5        # K6 vs plain: another f32 summation order
PFN_RTOL = 1e-5          # f32 PFN step from K6 vs plain
# steps 2-3 carry K6's rounding through an untrained network: measured
# 5.3e-5 on an H100 80GB HBM3 at 700 W
TRAIN_LOSS_RTOL = 1e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Mean milliseconds of fn() over `reps` warm calls, by CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main_path_inputs(engine, padded: torch.Tensor):
    """The tensors the main path hands each kernel for one served scan."""
    model = engine.model
    pts = engine.device_points(padded)
    geom = model.geom
    ctx = pz.bin_points(pts, geom)
    n = pts.shape[0]
    c3 = geom.num_cells_3d
    idxcap = 1 << max(n - 1, 1).bit_length()
    key = (torch.where(ctx.valid, ctx.cell, c3) * idxcap
           + torch.arange(n, dtype=torch.int32, device=pts.device))
    key = key.to(torch.int32)
    skey = sort.sort_i32_plain(key)
    local_s = torch.div(skey, idxcap, rounding_mode="floor")
    spts = pts[(skey - local_s * idxcap).long()].contiguous()
    kernel, bias = (model.voxel_feature_extractor.pfn_layers[0]
                    .effective_affine())
    mmat = pz.affine_pfn_weights(kernel, bias, pts.shape[1], geom,
                                 engine.cfg.with_distance)[0]
    return key, local_s[None].contiguous(), spts, mmat.float().contiguous()


def check_sort(key: torch.Tensor, rng) -> dict:
    dev = key.device
    cases = {"kitti_packed_keys": key,
             "duplicates_102400": torch.from_numpy(
                 rng.integers(-50, 50, 102_400).astype(np.int32)).to(dev)}
    for n in (1, 255, 256, 131_072):
        cases[f"random_{n}"] = torch.from_numpy(rng.integers(
            -2**31, 2**31 - 1, n).astype(np.int32)).to(dev)
    worst = 0
    for name, x in cases.items():
        got = sort.sort_i32(x)
        torch.cuda.synchronize()
        want = sort.sort_i32_plain(x)
        err = int((got.long() - want.long()).abs().max()) if x.numel() else 0
        require(err == 0 and torch.equal(got, torch.sort(x).values),
                f"K1 sort {name}: max |err| {err}")
        worst = max(worst, err)
    n = key.numel()
    m = sort.padded_size(n)
    stages = (m.bit_length() - 1) * m.bit_length() // 2
    bytes_moved = 2 * 4 * n
    ops = m // 2 * stages          # one comparison per compare-exchange
    return {
        "name": "bitonic_sort_i32", "max_abs_err": worst,
        "ms": time_ms(lambda: sort.sort_i32(key)),
        "plain_ms": time_ms(lambda: sort.sort_i32_plain(key), reps=3,
                            warm=1),
        "library_ms": time_ms(lambda: torch.sort(key)),
        **bound(bytes_moved, ops)}


def check_hist(local_s: torch.Tensor, ny: int, nx: int, rng) -> dict:
    perm = torch.from_numpy(rng.permutation(local_s.shape[1])).to(
        local_s.device)
    cases = {"kitti_sorted": local_s,
             "kitti_unsorted": local_s[:, perm].contiguous(),
             "all_drop": torch.full_like(local_s, ny * nx)}
    worst = 0
    for name, ids in cases.items():
        got = affine.histogram_counts(ids, ny, nx)
        want = affine.histogram_counts_plain(ids, ny, nx)
        err = int((got - want).abs().max())
        require(err == 0, f"K3 counts {name}: max |err| {err}")
        worst = max(worst, err)
    ids = local_s
    return {
        "name": "cell_histogram_i32", "max_abs_err": worst,
        "ms": time_ms(lambda: affine.histogram_counts(ids, ny, nx)),
        "plain_ms": time_ms(lambda: affine.histogram_counts_plain(
            ids, ny, nx)),
        "library_ms": time_ms(lambda: torch.bincount(
            ids[0], minlength=ny * nx + 1)),
        **bound(4 * ids.numel() + 4 * ny * nx, ids.numel())}


def scan_case(pts, counts, mmat, cap, dtype, what: str) -> float:
    """Kernel vs plain K2 on one input; returns the max |err| of the sums
    (count and smax must be exact, sums within rtol 1e-6)."""
    ends = (torch.cumsum(counts, 0) - 1).clamp(min=0).to(torch.int32)
    starts = (ends - counts + 1).contiguous()
    tot, smax = affine.affine_scan_gather(pts, starts, counts, mmat, cap,
                                          dtype)
    torch.cuda.synchronize()
    tot_p, smax_p = affine.affine_scan_gather_plain(pts, starts, counts,
                                                    mmat, cap, dtype)
    require(torch.equal(tot[:, 3], tot_p[:, 3]), f"K2 {what}: counts differ")
    require(torch.equal(smax.float(), smax_p.float()),
            f"K2 {what}: smax differs in "
            f"{int((smax.float() != smax_p.float()).sum())} entries")
    err = float((tot - tot_p).abs().max()) if tot.numel() else 0.0
    require(torch.allclose(tot, tot_p, rtol=1e-6, atol=0.0),
            f"K2 {what}: xyz sums differ by {err}")
    return err


def check_scan(spts, local_s, ny, nx, mmat, cap) -> dict:
    counts = affine.histogram_counts_plain(local_s, ny, nx).reshape(-1)
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for c in (cap, None):
            worst = max(worst, scan_case(spts, counts, mmat, c,
                                         dtype, f"kitti {dtype} cap={c}"))
    require(int(counts.max()) > cap, "the scan has a cell over the cap")
    one = torch.zeros_like(counts)
    one[ny * nx // 2] = 1
    worst = max(worst, scan_case(spts[:1].contiguous(), one, mmat,
                                 cap, torch.bfloat16, "single point"))
    worst = max(worst, scan_case(spts, torch.zeros_like(counts), mmat, cap,
                                 torch.bfloat16, "all invalid"))
    ends = (torch.cumsum(counts, 0) - 1).clamp(min=0).to(torch.int32)
    starts = (ends - counts + 1).contiguous()

    def kern():
        return affine.affine_scan_gather(spts, starts, counts, mmat, cap,
                                         torch.bfloat16)

    def plain():
        return affine.affine_scan_gather_plain(spts, starts, counts, mmat,
                                               cap, torch.bfloat16)

    kept = int(counts.clamp(max=cap).sum())
    a, width = mmat.shape
    ncells = counts.numel()
    bytes_moved = (4 * kept * a + 2 * 4 * ncells + 4 * a * width
                   + 4 * 4 * ncells + 2 * ncells * width)
    ops = kept * (width * (2 * a - 1 + 1) + 3)
    return {"name": "affine_scan_gather", "max_abs_err": worst,
            "ms": time_ms(kern), "plain_ms": time_ms(plain, reps=5, warm=1),
            "library_ms": None, **bound(bytes_moved, ops)}


def train_inputs(cfg, sd, points):
    """The tensors the training path hands K4/K5 and K6 for one (B, N, F)
    batch: the cell-sorted stream, run starts and counts, and mmat."""
    model = train.create_train_state(cfg, 1, state_dict=sd).model
    pts = torch.from_numpy(points).cuda()
    ctx = pz.bin_points_batch(pts, model.geom)
    spts, starts, counts = pz.cell_stream(pts.reshape(-1, pts.shape[-1]),
                                          ctx, model.geom)
    kernel, bias = (model.voxel_feature_extractor.pfn_layers[0]
                    .effective_affine())
    mmat = pz.affine_pfn_weights(kernel, bias, pts.shape[-1], model.geom,
                                 cfg.with_distance)[0]
    return (spts.contiguous(), starts, counts,
            mmat.detach().float().contiguous())


def argmax_case(pts, starts, counts, mmat, cap, dtype, what: str):
    """Kernel vs plain K4/K5 on one input: tot, smax and argpos exact."""
    packed = affine.packed_argmax(dtype, cap)
    fn = (affine.affine_scan_argmax_packed if packed
          else affine.affine_scan_argmax_pair)
    got = fn(pts, starts, counts, mmat, cap, dtype)
    torch.cuda.synchronize()
    want = affine.affine_scan_argmax_plain(pts, starts, counts, mmat, cap,
                                           dtype, packed)
    for name, g, w in zip(("tot", "smax", "argpos"), got, want):
        require(torch.equal(g.float(), w.float()),
                f"{fn.__name__} {what}: {name} differs in "
                f"{int((g.float() != w.float()).sum())} entries")
    return got


def check_argmax(spts, starts, counts, mmat, cap, packed: bool) -> dict:
    """K5 (packed) at bf16 / cap, or K4 at f32 / cap (the f32 training
    path), plus bf16 without a cap (K4), a single point and no points."""
    dtype = torch.bfloat16 if packed else torch.float32
    cases = [(spts, counts, cap, dtype, "kitti B=2")]
    if not packed:
        cases.append((spts, counts, None, torch.bfloat16, "bf16 no cap"))
    one = torch.zeros_like(counts)
    one[counts.numel() // 3] = 1
    s0 = torch.zeros_like(starts)
    cases += [(spts[:1].contiguous(), one, cap, dtype, "single point"),
              (spts, torch.zeros_like(counts), cap, dtype, "all invalid")]
    for pts, cnt, c, dt, what in cases:
        argmax_case(pts, s0 if pts.shape[0] == 1 else starts, cnt, mmat, c,
                    dt, what)
    require(int(counts.max()) > cap, "the batch has a cell over the cap")
    fn = (affine.affine_scan_argmax_packed if packed
          else affine.affine_scan_argmax_pair)

    def kern():
        return fn(spts, starts, counts, mmat, cap, dtype)

    def plain():
        return affine.affine_scan_argmax_plain(spts, starts, counts, mmat,
                                               cap, dtype, packed)

    kept = int(counts.clamp(max=cap).sum())
    a, width = mmat.shape
    ncells = counts.numel()
    out_bytes = 2 if packed else 4
    bytes_moved = (4 * kept * a + 2 * 4 * ncells + 4 * a * width
                   + 4 * 4 * ncells + (out_bytes + 4) * ncells * width)
    ops = kept * (width * (2 * a - 1 + 1) + 3)
    return {"name": ("affine_scan_argmax_packed" if packed
                     else "affine_scan_argmax_pair"),
            "max_abs_err": 0.0, "ms": time_ms(kern),
            "plain_ms": time_ms(plain, reps=3, warm=1), "library_ms": None,
            **bound(bytes_moved, ops)}


def check_dmmat(spts, starts, counts, mmat, cap, rng) -> dict:
    """K6 against its plain version on the argmax rows of K5 (bf16, the
    flagship) and K4 (f32), within DMMAT_RTOL of the result's scale, and
    the same bits on a second run."""
    worst = 0.0
    inputs = {}
    for dtype in (torch.bfloat16, torch.float32):
        fn = (affine.affine_scan_argmax_packed if dtype == torch.bfloat16
              else affine.affine_scan_argmax_pair)
        _, smax, pos = fn(spts, starts, counts, mmat, cap, dtype)
        d = torch.from_numpy(rng.normal(size=tuple(smax.shape)).astype(
            np.float32)).cuda().to(dtype)
        got = affine.affine_bwd_dmmat(spts, pos, d, counts, dtype)
        again = affine.affine_bwd_dmmat(spts, pos, d, counts, dtype)
        torch.cuda.synchronize()
        want = affine.affine_bwd_dmmat_plain(spts, pos, d, counts, dtype)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        require(err <= DMMAT_RTOL * scale,
                f"K6 {dtype}: |err| {err} over {DMMAT_RTOL} x {scale}")
        require(torch.equal(got, again), f"K6 {dtype}: runs differ")
        worst = max(worst, err)
        inputs[dtype] = (pos, d)
    dtype = torch.bfloat16                     # timed: the flagship's type
    pos, d = inputs[dtype]
    live = (counts > 0)[:, None] & (pos >= 0)
    rows = int(torch.unique(pos[live]).numel())
    a, width = mmat.shape
    ncells = counts.numel()
    bytes_moved = (4 * ncells * width + 2 * ncells * width + 4 * ncells
                   + 4 * a * rows + 4 * a * width)
    ops = 2 * a * int(live.sum())
    return {"name": "affine_bwd_dmmat", "max_abs_err": worst,
            "ms": time_ms(lambda: affine.affine_bwd_dmmat(
                spts, pos, d, counts, dtype)),
            "plain_ms": time_ms(lambda: affine.affine_bwd_dmmat_plain(
                spts, pos, d, counts, dtype)),
            "library_ms": None, **bound(bytes_moved, ops)}


def bound(bytes_moved: int, ops: int) -> dict:
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_moved, "operations": ops}


def set_bn_stats(sd: dict, rng) -> None:
    """Non-trivial running statistics, so eval-mode batch norm is not the
    identity."""
    for name, t in sd.items():
        if name.endswith("running_mean"):
            t.copy_(torch.from_numpy(rng.normal(0, 0.2, t.shape)))
        elif name.endswith("running_var"):
            t.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, t.shape)))


COUNTERS = (sort.sort_i32, affine.histogram_counts,
            affine.affine_scan_gather, affine.affine_scan_argmax_pair,
            affine.affine_scan_argmax_packed, affine.affine_bwd_dmmat)


def reset_launches() -> None:
    torch.cuda.synchronize()
    for fn in COUNTERS:
        fn.launches = 0


def read_launches(launched, idle, path: str) -> dict:
    """The launch counts of a path just driven: every wrapper in `launched`
    must have launched, none in `idle`."""
    torch.cuda.synchronize()
    counts = {fn.__name__: fn.launches for fn in COUNTERS}
    for fn in launched:
        require(fn.launches > 0, f"{fn.__name__} was not launched on the "
                                 f"{path} path")
    for fn in idle:
        require(fn.launches == 0, f"{fn.__name__} was launched "
                                  f"{fn.launches} times on the {path} path")
    return counts


def serve(cfg, sd, scans, device) -> dict:
    engine = GroundInferenceEngine(cfg, sd, device=device)
    warm_s = engine.warmup()
    reset_launches()
    t0 = time.perf_counter()
    outs = [engine.infer(s) for s in scans]
    elapsed = time.perf_counter() - t0
    launches = read_launches(COUNTERS[:3], COUNTERS[3:], "serve")
    for (elev, labels), scan in zip(outs, scans):
        require(elev.shape == (cfg.ny, cfg.nx) and np.isfinite(elev).all(),
                "elevation finite and (ny, nx)")
        require(labels.shape == (scan.shape[0],)
                and set(np.unique(labels)) <= {-1, 0, 1}, "labels in -1/0/1")
    n_lab = np.concatenate([lab for _, lab in outs])
    return {"launches": launches, "result": {
        "phase": "serve", "scans": len(scans),
        "points_per_scan": int(scans[0].shape[0]),
        "warmup_s": warm_s, "seconds": elapsed,
        "scans_per_s": len(scans) / elapsed, "launches": launches,
        "label_share": {str(v): float((n_lab == v).mean())
                        for v in (-1, 0, 1)}}}


def parity(cfg, sd, scans, device) -> dict:
    """Kernel path vs the plain path on the card at float32 / 'highest'."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = cfg.replace(compute_dtype="float32", matmul_precision="highest")
    engine = GroundInferenceEngine(cfg32, sd, device=device)
    elev_tol = 1e-4
    worst = {"canvas": 0.0, "elevation": 0.0, "label_mismatch": 0}
    for scan in scans:
        padded, n = engine._prepare(scan)
        padded = torch.from_numpy(padded)
        pts = engine.device_points(padded)
        with torch.no_grad():
            ck = engine.model.canvas(pts[None])
            cp = engine.model.canvas(pts[None], reference=True)
        d_canvas = float((ck - cp).abs().max())
        require(d_canvas <= 1e-5, f"f32 canvas kernel vs plain {d_canvas}")
        ek, lk = engine.run(padded)
        ep, lp = engine.run(padded, reference=True)
        d_elev = float((ek - ep).abs().max())
        require(d_elev <= elev_tol, f"f32 elevation kernel vs plain {d_elev}")
        diff = (lk != lp).nonzero()[:, 0]
        if diff.numel():
            ix, iy = _cell_indices(pts[diff], cfg.grid_range,
                                   cfg.voxel_size[0])
            ix = ix.clamp(0, cfg.nx - 1).long()
            iy = iy.clamp(0, cfg.ny - 1).long()
            margin = (pts[diff, 2] - ep.t()[ix, iy]
                      - engine.threshold).abs()
            require(bool((margin <= elev_tol).all()),
                    "labels differ away from the threshold")
        worst["canvas"] = max(worst["canvas"], d_canvas)
        worst["elevation"] = max(worst["elevation"], d_elev)
        worst["label_mismatch"] += int(diff.numel())
    return {"phase": "parity_f32", "scans": len(scans),
            "canvas_atol": 1e-5, "elevation_atol": elev_tol,
            "max_abs_diff": worst}


def params_of(state) -> dict:
    return {k: v.detach().clone()
            for k, v in state.model.named_parameters()}


def train_phase(cfg, sd, rng) -> dict:
    """kitti_sem training at B=2 through make_train_step, then steps/s at
    B=16 on the same path."""
    points, labels = synthetic_labelled_batch(cfg, rng, TRAIN_BATCH,
                                              cfg.num_points)
    state = train.create_train_state(cfg, 100, state_dict=sd)
    step = train.make_train_step(cfg)
    before = params_of(state)
    state, loss = step(state, points, labels)           # warm: cuDNN plans
    require(bool(torch.isfinite(loss)), "first train loss finite")
    reset_launches()
    steps = 5
    t0 = time.perf_counter()
    losses = []
    for _ in range(steps):
        state, loss = step(state, points, labels)
        losses.append(loss)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_launches(
        (affine.histogram_counts, affine.affine_scan_argmax_packed,
         affine.affine_bwd_dmmat),
        (affine.affine_scan_gather, affine.affine_scan_argmax_pair,
         sort.sort_i32), "train")
    losses = [float(v) for v in losses]
    require(all(np.isfinite(losses)), f"train losses finite: {losses}")
    moved = {k: bool((v != before[k]).any())
             for k, v in params_of(state).items()}
    require(all(moved.values()), "parameters that did not move: "
            f"{[k for k, v in moved.items() if not v]}")

    big = synthetic_labelled_batch(cfg, rng, BENCH_BATCH, cfg.num_points)
    big_state = train.create_train_state(cfg, 100, state_dict=sd)
    big_state, loss = step(big_state, *big)
    torch.cuda.synchronize()
    big_steps = 3
    t0 = time.perf_counter()
    for _ in range(big_steps):
        big_state, loss = step(big_state, *big)
    torch.cuda.synchronize()
    big_elapsed = time.perf_counter() - t0
    require(bool(torch.isfinite(loss)), "B=16 train loss finite")
    return {"launches": launches, "result": {
        "phase": "train", "batch": TRAIN_BATCH,
        "points_per_scan": int(points.shape[1]), "steps": steps,
        "seconds": elapsed, "steps_per_s": steps / elapsed,
        "scans_per_s": steps * TRAIN_BATCH / elapsed, "losses": losses,
        "launches": launches, "params_moved": len(moved),
        "bench_batch": BENCH_BATCH, "bench_steps": big_steps,
        "bench_steps_per_s": big_steps / big_elapsed,
        "bench_scans_per_s": big_steps * BENCH_BATCH / big_elapsed,
        "bench_loss": float(loss),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}}


def train_parity(cfg, sd, rng) -> dict:
    """Three float32 / 'highest' train steps with TF32 off and cuDNN's
    deterministic algorithms, kernel path (K3, K4, K6) against the plain
    path.  The forward is the same to the bit (K4 is exact), so after the
    first step the loss and every SegNet parameter must be identical and
    the PFN parameters, whose gradient comes from K6 (another f32
    summation order), within PFN_RTOL of their scale.  Later steps carry
    that rounding through an untrained network, so only their losses are
    compared, within TRAIN_LOSS_RTOL."""
    cfg32 = cfg.replace(compute_dtype="float32", matmul_precision="highest")
    points, labels = synthetic_labelled_batch(cfg32, rng, TRAIN_BATCH,
                                              cfg.num_points)
    kern = train.create_train_state(cfg32, 100, state_dict=sd)
    plain = train.create_train_state(cfg32, 100, state_dict=sd)
    step_k = train.make_train_step(cfg32)
    step_p = train.make_train_step(cfg32, reference=True)
    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        reset_launches()
        lk = [float(step_k(kern, points, labels)[1])]
        launches = read_launches(
            (affine.histogram_counts, affine.affine_scan_argmax_pair,
             affine.affine_bwd_dmmat),
            (affine.affine_scan_argmax_packed, affine.affine_scan_gather),
            "train_f32")
        lp = [float(step_p(plain, points, labels)[1])]
        pk, pp = params_of(kern), params_of(plain)
        diffs = {name: float((pk[name] - w).abs().max())
                 / max(float(w.abs().max()), 1e-12)
                 for name, w in pp.items()}
        seg = max(v for k, v in diffs.items() if k.startswith("encoder"))
        pfn = max(v for k, v in diffs.items() if k.startswith("voxel"))
        require(lk[0] == lp[0], f"f32 first-step losses {lk[0]} {lp[0]}")
        require(seg == 0.0, f"f32 first step: SegNet parameters differ by "
                            f"{seg} of scale")
        require(pfn <= PFN_RTOL, f"f32 first step: PFN parameters differ "
                                 f"by {pfn} of scale")
        for _ in range(2):
            lk.append(float(step_k(kern, points, labels)[1]))
            lp.append(float(step_p(plain, points, labels)[1]))
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = prev
    d_loss = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    require(d_loss <= TRAIN_LOSS_RTOL, f"f32 train loss rel diff {d_loss}")
    pk, pp = params_of(kern), params_of(plain)
    after = max(float((pk[n] - w).abs().max()) / max(float(w.abs().max()),
                                                     1e-12)
                for n, w in pp.items())
    return {"launches": launches, "result": {
        "phase": "train_parity_f32", "steps": 3, "losses_kernel": lk,
        "losses_plain": lp, "loss_rel_diff": d_loss,
        "loss_rtol": TRAIN_LOSS_RTOL,
        "step1_segnet_param_diff_of_scale": seg,
        "step1_pfn_param_diff_of_scale": pfn, "pfn_rtol": PFN_RTOL,
        "step3_param_diff_of_scale": after, "launches": launches}}


REPLACES = {
    "bitonic_sort_i32": ("gndnet_tpu/ops/pallas_sort.py:230",
                         "gndnet_tpu_torch/csrc/bitonic_sort.cu"),
    "cell_histogram_i32": ("gndnet_tpu/ops/pallas_affine.py:904",
                           "gndnet_tpu_torch/csrc/cell_histogram.cu"),
    "affine_scan_gather": ("gndnet_tpu/ops/pallas_affine.py:522",
                           "gndnet_tpu_torch/csrc/affine_scan.cu"),
    "affine_scan_argmax_pair": ("gndnet_tpu/ops/pallas_affine.py:522",
                                "gndnet_tpu_torch/csrc/affine_scan.cu"),
    "affine_scan_argmax_packed": ("gndnet_tpu/ops/pallas_affine.py:522",
                                  "gndnet_tpu_torch/csrc/affine_scan.cu"),
    "affine_bwd_dmmat": ("gndnet_tpu/ops/pallas_affine.py:686",
                         "gndnet_tpu_torch/csrc/affine_bwd.cu"),
}
# kernel row -> (wrapper, the path whose run gives its `launches`)
WRAPPER = {"bitonic_sort_i32": ("sort_i32", "serve"),
           "cell_histogram_i32": ("histogram_counts", "serve"),
           "affine_scan_gather": ("affine_scan_gather", "serve"),
           "affine_scan_argmax_pair": ("affine_scan_argmax_pair",
                                       "train_f32"),
           "affine_scan_argmax_packed": ("affine_scan_argmax_packed",
                                         "train"),
           "affine_bwd_dmmat": ("affine_bwd_dmmat", "train")}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    emit({"phase": "build", "seconds": _ext.build_all()})
    cfg = kitti_sem_config().replace(
        compute_dtype="bfloat16", matmul_precision="default",
        fused_impl="affine")
    kernels = run(cfg, cfg.num_points, "cuda")
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


def run(cfg, n_points: int, device) -> list:
    """Phases 3-7 on `device`; returns the kernels line's entries."""
    rng = np.random.default_rng(SEED)
    sd = init_state_dict(cfg, seed=SEED)
    set_bn_stats(sd, rng)
    scans = [synthetic_scan(cfg, rng, n_points) for _ in range(6)]

    probe = GroundInferenceEngine(cfg, sd, device=device)
    padded, _ = probe._prepare(scans[0])
    key, local_s, spts, mmat = main_path_inputs(probe,
                                                torch.from_numpy(padded))
    cap = cfg.max_points_voxel
    rows = [check_sort(key, rng),
            check_hist(local_s, cfg.ny, cfg.nx, rng),
            check_scan(spts, local_s, cfg.ny, cfg.nx, mmat, cap)]
    batch, _ = synthetic_labelled_batch(cfg, rng, TRAIN_BATCH, n_points)
    tpts, tstarts, tcounts, tmmat = train_inputs(cfg, sd, batch)
    rows += [check_argmax(tpts, tstarts, tcounts, tmmat, cap, packed=False),
             check_argmax(tpts, tstarts, tcounts, tmmat, cap, packed=True),
             check_dmmat(tpts, tstarts, tcounts, tmmat, cap, rng)]
    for row in rows:
        emit({"phase": "kernel", "kernel_ms": row["ms"], **row})

    paths = {}
    served = serve(cfg, sd, scans, device)
    paths["serve"] = served["launches"]
    emit(served["result"])
    emit(parity(cfg, sd, scans[:2], device))
    trained = train_phase(cfg, sd, rng)
    paths["train"] = trained["launches"]
    emit(trained["result"])
    tparity = train_parity(cfg, sd, rng)
    paths["train_f32"] = tparity["launches"]
    emit(tparity["result"])

    kernels = []
    for row in rows:
        replaces, source = REPLACES[row["name"]]
        wrapper, path = WRAPPER[row["name"]]
        kernels.append({
            "name": row["name"], "route": "cuda", "source": source,
            "replaces": replaces, "launches": paths[path][wrapper],
            "launches_path": path,
            "launches_by_path": {p: c[wrapper] for p, c in paths.items()},
            "max_abs_err": row["max_abs_err"], "max_err": row["max_abs_err"],
            "ms": row["ms"], "kernel_ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    return kernels


if __name__ == "__main__":
    sys.exit(main())
