#!/usr/bin/env python3
"""Card smoke test of gndnet_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each printing one JSON line:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile every kernel of csrc/ with nvcc;
  3. kernels: each hand-written kernel (K1 sort, K3 cell counts and run
     ends, K2 capped scan at the serving shapes; K4 and K5 argmax scans
     and K6 d(mmat) at the kitti_sem B=2 training shapes; K7 at the
     sorted frontend's; K10 pair sort on the fine_grid affine path's
     (cell, iota) pairs; K8 and K9 at profile_affine's shapes) against
     its plain PyTorch version on the card, with edge cases, its time,
     the plain version's time and a library call's time (CUDA events over
     warm repetitions).  K1 and K10
     are the cluster radix sort up to its capacity, which the card must
     confirm, and the bitonic kernels above it; both paths are checked,
     and their rows add the bitonic kernel's time at the main path's shape
     (`earlier_ms`), and the kernels one call of the wrapper and of the
     library call enqueue, with their device time (torch.profiler).  The
     K2-K9 rows add the device operations one call enqueues and their
     device time: one for K2-K6, K8 and K9 (at most two are allowed for
     K8 and K9), at most two (a memset and the kernel) for K7; K6, K8 and
     K9 give the same bits in 20 back-to-back calls.  K3 is checked on every route (each cluster size, the
     global route above its capacity, which the card must confirm), with
     its ends, on a B=16 burst and on fine_grid's ids, and reports the
     time of clusters of 8 and 16 CTAs (`cluster_sizes`) and
     `torch.bincount`'s device time;
  4. serve: kitti_sem single-scan serving (bf16 convs, 'default' precision,
     random weights from a seed) of synthetic 100 000-point scans through
     GroundInferenceEngine on the card; K1-K3 must launch once per scan and
     no other kernel, elevations must be finite and labels in {-1, 0, 1};
  5. parity: the same engine at float32 / 'highest' with TF32 off, kernel
     path against the plain path on the card;
  6. train: kitti_sem training at B=2 (bf16, 'default', affine) on
     synthetic labelled scans through make_train_step: K3, K5 and K6 must
     launch and no other kernel, the loss must stay finite and every
     parameter move; steps/s at B=2 and at B=16 (bench.py's train batch),
     and the device operations and device ms of a B=2 step;
  7. train_parity: three float32 / 'highest' train steps with TF32 off,
     kernel path (K4, K6) against the plain path, and the device
     operations and device ms of a kernel-path step;
  8. serve_sorted: the same serving with fused_impl='sorted': K7 must
     launch 3 times per scan and no other kernel;
  9. serve_scatter: kitti_sem_config() exactly as shipped ('scatter',
     float32, 'highest', TF32 off): no kernel launches;
 10. serve_fine_grid: fine_grid_config() as shipped (250x250), two scans
     each through 'scatter' and 'sorted';
 11. parity_sorted: float32 / 'highest', the sorted kernel path against
     its plain path, and sorted against scatter, on the card;
 12. train_scatter: kitti_sem as shipped, B=2, three steps, with the PFN
     plain and with use_norm's batch-statistics BN; no kernel launches;
 13. presets: camera, custom_local and fine_grid as shipped serve a scan
     and take a B=2 train step with use_norm off and on;
 14. serve_fine_grid_affine: fine_grid at the serving settings ('affine',
     bf16, 'default'), four scans: K10, K3 and K2 once per scan, no other
     kernel (the packed key overflows, so K10 sorts the pairs, not K1);
 15. parity_fine_grid: the same at float32 / 'highest', TF32 off, kernel
     path against the plain path and affine against scatter;
 16. train_fine_grid_affine: fine_grid through 'affine' at B=2 (bf16),
     three steps: the stable batched sort, K3, K5 and K6, no K10;
 17. serve_many: `infer_many` bursts of kitti_sem scans at K=4 and K=16
     and of fine_grid scans at K=2: one fused call each (K3 and K2 once,
     K1 and K10 never), the batched canvas equal to the per-scan ones and
     each elevation within SERVE_MANY_ELEV_ATOL of per-scan `infer`;
 18. profile_affine: the stage profile's K8, K10 and K9 cases, the
     launches that the kernels line reports for K8 and K9;
 19. the kernels line, the card line, then the result line.
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

from gndnet_tpu_torch import _ext, profile_affine, train
from gndnet_tpu_torch.config import (camera_config, custom_local_config,
                                     fine_grid_config, kitti_sem_config)
from gndnet_tpu_torch.infer import GroundInferenceEngine
from gndnet_tpu_torch.ops import affine, affine_aux, segment, sort
from gndnet_tpu_torch.ops import pillarize as pz
from gndnet_tpu_torch.ops.postproc import _cell_indices
from gndnet_tpu_torch.profile_affine import serving_config, time_ms
from gndnet_tpu_torch.profile_serve import kernel_times
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
# the sorted impl's canvas against the scatter impl's, the JAX package's
# own tolerance (tests/test_pillarize.py:277-279)
IMPL_RTOL, IMPL_ATOL = 1e-4, 1e-5
# their elevations: scatter sums with atomics in a varying order, so its
# canvas lies a few 1e-6 from the sorted one, and the SegNet routes its
# unpool by max-pool argmax, where a near-tied window can flip: measured
# 1.45e-3 on an H100 80GB HBM3 at 700 W
IMPL_ELEV_ATOL = 1e-2
# infer_many against per-scan infer, bf16 convs: the canvases are equal,
# the SegNet at B=K may convolve in another order than at B=1, which the
# argmax routing can amplify as above: measured 1.46e-3 on an H100 80GB
# HBM3 at 700 W
SERVE_MANY_ELEV_ATOL = 1e-2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


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


def device_profile(fn) -> tuple:
    """The CUDA kernels one warm call of fn() enqueues and their device
    milliseconds, by torch.profiler over 20 calls; again, up to 3 windows,
    when a window recorded no device activity (torch.profiler now and then
    drops a window's device records in a long process)."""
    fn()
    for _ in range(3):
        prof = kernel_times(fn, 20)
        if isinstance(prof.get("device_ops_per_call"), float):
            return prof["device_ops_per_call"], prof["device_ms_per_call"]
    require(False, "the profiler saw no kernel in 3 windows")


def check_sort(key: torch.Tensor, rng) -> dict:
    """K1 (the cluster radix sort up to RADIX_MAX_I32 keys, the bitonic
    network above) against its plain version and torch.sort: the kitti_sem
    packed keys (and with two indices swapped across CTAs), duplicates,
    both int32 extremes, a constant digit, short and power-of-two lengths,
    the capacity and 2^20 keys (bitonic)."""
    dev = key.device
    cap = _ext.function("cluster_radix_sort_capacity")(4)
    require(cap == sort.RADIX_MAX_I32, f"K1 capacity on this card {cap}, "
                                       f"ops/sort.py {sort.RADIX_MAX_I32}")
    extremes = rng.integers(-5, 5, 102_400).astype(np.int32)
    extremes[rng.permutation(102_400)[:120]] = np.repeat(
        [2**31 - 1, -2**31], 60)
    constant = rng.integers(-2**20, 2**20, 102_400)
    swapped = key.clone()                 # low bits out of order once,
    swapped[6399], swapped[6400] = key[6400], key[6399]   # across CTAs
    cases = {"kitti_packed_keys": key,
             "kitti_packed_keys_swapped": swapped,
             "duplicates_102400": torch.from_numpy(
                 rng.integers(-50, 50, 102_400).astype(np.int32)).to(dev),
             "extremes_102400": torch.from_numpy(extremes).to(dev),
             "constant_digit_102400": torch.from_numpy(
                 ((constant & ~0xFF00) | 0x3700).astype(np.int32)).to(dev)}
    for n in (1, 2, 255, 257, 4097, 131_072, sort.RADIX_MAX_I32, 1 << 20):
        cases[f"random_{n}"] = torch.from_numpy(rng.integers(
            -2**31, 2**31 - 1, n, endpoint=True).astype(np.int32)).to(dev)
    for name, x in cases.items():
        before = sort.sort_i32.launches
        got = sort.sort_i32(x)
        torch.cuda.synchronize()
        require(sort.sort_i32.launches == before + 1,
                f"K1 {name}: {sort.sort_i32.launches - before} launches")
        want = sort.sort_i32_plain(x)
        require(torch.equal(got, want) and torch.equal(
            got, torch.sort(x).values), f"K1 sort {name}: differs in "
            f"{int((got != want).sum())} entries")
    launches, device_ms = device_profile(lambda: sort.sort_i32(key))
    require(round(launches) == 1, f"K1 enqueues {launches} kernels a call")
    lib_launches, lib_device_ms = device_profile(lambda: torch.sort(key))
    n = key.numel()
    bitonic = _ext.function("bitonic_sort_i32")
    buf = sort._padded(key)
    stream = _ext.stream_ptr(key)
    _ext.check(bitonic(buf.data_ptr(), buf.numel(), stream),
               "bitonic_sort_i32")
    return {
        "name": "cluster_radix_sort_i32", "max_abs_err": 0,
        "ms": time_ms(lambda: sort.sort_i32(key)),
        "earlier_ms": time_ms(lambda: bitonic(buf.data_ptr(), buf.numel(),
                                              stream)),
        "earlier": "bitonic_sort_i32 (csrc/bitonic_sort.cu) on the keys "
                   "padded to a power of two",
        "plain_ms": time_ms(lambda: sort.sort_i32_plain(key), reps=3,
                            warm=1),
        "library_ms": time_ms(lambda: torch.sort(key)),
        "library": "torch.sort",
        "device_launches_per_call": launches, "device_ms": device_ms,
        "library_device_launches_per_call": lib_launches,
        "library_device_ms": lib_device_ms,
        "capacity": cap, "shape": [n], **bound(2 * 4 * n, 0)}


def burst_ids(engine, scans) -> torch.Tensor:
    """The (K, N) sorted local cell ids a batched call hands K3 for a burst
    of K scans (`cell_stream` at B=K; drop id ny*nx)."""
    padded = torch.from_numpy(np.stack([engine._prepare(s)[0]
                                        for s in scans]))
    pts = engine.device_points(padded)
    geom = engine.model.geom
    ctx = pz.bin_points_batch(pts, geom)
    b, n = pts.shape[:2]
    c3 = geom.num_cells_3d
    item = torch.arange(b, dtype=torch.int32, device=pts.device)
    local = torch.where(ctx.valid, ctx.cell - item.repeat_interleave(n) * c3,
                        c3).reshape(b, n)
    return torch.sort(local, dim=-1).values.contiguous()


def hist_case(ids, ny, nx, cluster, what: str) -> None:
    """K3 on one input, with ends and without: counts and ends equal to
    the plain versions', one launch a call."""
    before = K3.launches
    ends, counts = affine.cell_histogram(ids, ny, nx, True, cluster)
    _, alone = affine.cell_histogram(ids, ny, nx, False, cluster)
    torch.cuda.synchronize()
    require(K3.launches == before + 2, f"K3 {what}: "
                                       f"{K3.launches - before} launches")
    want_ends, want_counts = affine.histogram_ends_plain(ids, ny, nx)
    for name, got, want in (("counts", counts, want_counts),
                            ("counts alone", alone, want_counts),
                            ("ends", ends, want_ends)):
        require(torch.equal(got, want), f"K3 {what}: {name} differ in "
                f"{int((got != want).sum())} entries")


def check_hist(local_s, ny, nx, rng, burst, fine) -> dict:
    """K3 (one cluster launch a call, its counters in distributed shared
    memory, up to HIST_CLUSTER_MAX_CELLS cells; the global route above,
    which the card must confirm) against the plain counts and ends: the
    main path's sorted ids, unsorted, all drop ids, an `infer_many` burst
    of 16 scans, fine_grid's 250x250 on its own ids, a grid just above the
    cluster's capacity, every cluster size and the global route on the
    main path's ids, and twenty repeated calls alike.  Times the main
    path's `histogram_ends`, and clusters of 8 and 16 CTAs (the size
    rule's measurement)."""
    cap = _ext.function("cell_histogram_capacity")()
    require(cap == affine.HIST_CLUSTER_MAX_CELLS,
            f"K3 capacity on this card {cap}, ops/affine.py "
            f"{affine.HIST_CLUSTER_MAX_CELLS}")
    fine_ids, fine_ny, fine_nx = fine
    big_ny, big_nx = 2, affine.HIST_CLUSTER_MAX_CELLS // 2 + 1
    require(affine.histogram_cluster(big_ny * big_nx) == 0,
            "the grid above capacity takes the global route")
    big = torch.sort(torch.from_numpy(rng.integers(
        0, big_ny * big_nx + 1, (2, local_s.shape[1])).astype(
            np.int32)).cuda(), dim=-1).values
    perm = torch.from_numpy(rng.permutation(local_s.shape[1])).to(
        local_s.device)
    cases = [("kitti_sorted", local_s, ny, nx, None),
             ("kitti_unsorted", local_s[:, perm].contiguous(), ny, nx, None),
             ("all_drop", torch.full_like(local_s, ny * nx), ny, nx, None),
             ("kitti_burst_B16", burst, ny, nx, None),
             ("fine_grid_250x250", fine_ids, fine_ny, fine_nx, None),
             ("above_capacity", big, big_ny, big_nx, None)]
    cases += [(f"kitti_cluster_{g}", local_s, ny, nx, g)
              for g in (0, 1, 2, 4, 8, 16)]
    for name, ids, gy, gx, g in cases:
        hist_case(ids, gy, gx, g, name)
    first = affine.histogram_ends(local_s, ny, nx)
    for _ in range(20):
        again = affine.histogram_ends(local_s, ny, nx)
        require(all(torch.equal(a, b) for a, b in zip(first, again)),
                "K3: repeated calls differ")
    ids = local_s
    launches, device_ms = device_profile(
        lambda: affine.histogram_ends(ids, ny, nx))
    require(round(launches) == 1, f"K3 ends enqueues {launches} device "
                                  "operations a call, not 1")
    alone, alone_ms = device_profile(
        lambda: affine.histogram_counts(ids, ny, nx))
    require(round(alone) == 1, f"K3 counts enqueue {alone} device "
                               "operations a call, not 1")

    def library():
        return torch.bincount(ids[0], minlength=ny * nx + 1)

    lib_launches, lib_device_ms = device_profile(library)
    sizes = {}
    for what, x, gy, gx in (("kitti_B1", local_s, ny, nx),
                            ("kitti_B16", burst, ny, nx),
                            ("fine_grid_B1", fine_ids, fine_ny, fine_nx)):
        for g in (8, 16):
            def fn():
                return affine.cell_histogram(x, gy, gx, True, g)
            sizes[f"{what}_cluster_{g}"] = {
                "ms": time_ms(fn), "device_ms": device_profile(fn)[1]}
    return {
        "name": "cell_histogram_i32", "max_abs_err": 0,
        "ms": time_ms(lambda: affine.histogram_ends(ids, ny, nx)),
        "plain_ms": time_ms(lambda: affine.histogram_ends_plain(
            ids, ny, nx)),
        "library_ms": time_ms(library), "library": "torch.bincount",
        "device_launches_per_call": launches, "device_ms": device_ms,
        "library_device_launches_per_call": lib_launches,
        "library_device_ms": lib_device_ms, "capacity": cap,
        "counts_ms": time_ms(lambda: affine.histogram_counts(ids, ny, nx)),
        "counts_device_ms": alone_ms,
        "cluster": affine.histogram_cluster(ny * nx),
        "cluster_sizes": sizes,
        **bound(4 * ids.numel() + 2 * 4 * ny * nx, ids.numel())}


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

    launches, device_ms = device_profile(kern)
    require(round(launches) == 1, f"K2 enqueues {launches} device "
                                  "operations a call, not 1")
    kept = int(counts.clamp(max=cap).sum())
    a, width = mmat.shape
    ncells = counts.numel()
    bytes_moved = (4 * kept * a + 2 * 4 * ncells + 4 * a * width
                   + 4 * 4 * ncells + 2 * ncells * width)
    ops = kept * (width * (2 * a - 1 + 1) + 3)
    return {"name": "affine_scan_gather", "max_abs_err": worst,
            "ms": time_ms(kern), "plain_ms": time_ms(plain, reps=5, warm=1),
            "library_ms": None, "device_launches_per_call": launches,
            "device_ms": device_ms, **bound(bytes_moved, ops)}


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


def check_argmax(spts, starts, counts, mmat, cap, packed: bool,
                 rng) -> dict:
    """K5 (packed) at bf16 / cap, or K4 at f32 / cap (the f32 training
    path), plus bf16 without a cap (K4), a single point, no points, and one
    cell of 5 000 points at cap 100 and at cap 4096 (the packed key's
    12-bit rank field), and for K4 without a cap."""
    dtype = torch.bfloat16 if packed else torch.float32
    cases = [(spts, counts, cap, dtype, "kitti B=2")]
    if not packed:
        cases.append((spts, counts, None, torch.bfloat16, "bf16 no cap"))
    one = torch.zeros_like(counts)
    one[counts.numel() // 3] = 1
    s0 = torch.zeros_like(starts)
    cases += [(spts[:1].contiguous(), one, cap, dtype, "single point"),
              (spts, torch.zeros_like(counts), cap, dtype, "all invalid")]
    long_run = torch.zeros_like(counts)
    long_run[counts.numel() // 2] = 5000
    long_pts = torch.from_numpy((rng.normal(size=(5000, spts.shape[1]))
                                 * 10).astype(np.float32)).cuda()
    cases += [(long_pts, long_run, c, dtype, f"5000-point cell, cap {c}")
              for c in (100, affine.PACKED_MAX_CAP)]
    if not packed:           # past the packed key's 4096 rows
        cases.append((long_pts, long_run, None, dtype,
                      "5000-point cell, no cap"))
    for pts, cnt, c, dt, what in cases:
        argmax_case(pts, starts if pts is spts else s0, cnt, mmat, c, dt,
                    what)
    require(int(counts.max()) > cap, "the batch has a cell over the cap")
    fn = (affine.affine_scan_argmax_packed if packed
          else affine.affine_scan_argmax_pair)

    def kern():
        return fn(spts, starts, counts, mmat, cap, dtype)

    def plain():
        return affine.affine_scan_argmax_plain(spts, starts, counts, mmat,
                                               cap, dtype, packed)

    launches, device_ms = device_profile(kern)
    require(round(launches) == 1, f"{fn.__name__} enqueues {launches} "
                                  "device operations a call, not 1")
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
            "device_launches_per_call": launches, "device_ms": device_ms,
            **bound(bytes_moved, ops)}


def check_dmmat(spts, starts, counts, mmat, cap, rng) -> dict:
    """K6 against its plain version on the argmax rows of K5 (bf16, the
    flagship) and K4 (f32), within DMMAT_RTOL of the result's scale, the
    same bits in 20 calls, and one device operation a call.  Its bound
    counts what the function must read: the counts, the argpos and d_smax
    rows of the occupied cells, the distinct argmax rows of pts, and the
    output (`bound_ms_full_tables`: every cell's rows, as charged before
    the kernel skipped empty cells)."""
    worst = 0.0
    inputs, device = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        fn = (affine.affine_scan_argmax_packed if dtype == torch.bfloat16
              else affine.affine_scan_argmax_pair)
        _, smax, pos = fn(spts, starts, counts, mmat, cap, dtype)
        d = torch.from_numpy(rng.normal(size=tuple(smax.shape)).astype(
            np.float32)).cuda().to(dtype)
        got = affine.affine_bwd_dmmat(spts, pos, d, counts, dtype)
        again = [affine.affine_bwd_dmmat(spts, pos, d, counts, dtype)
                 for _ in range(19)]
        torch.cuda.synchronize()
        want = affine.affine_bwd_dmmat_plain(spts, pos, d, counts, dtype)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        require(err <= DMMAT_RTOL * scale,
                f"K6 {dtype}: |err| {err} over {DMMAT_RTOL} x {scale}")
        require(all(torch.equal(got, g) for g in again),
                f"K6 {dtype}: calls differ")
        worst = max(worst, err)
        inputs[dtype] = (pos, d)
        device[dtype] = device_profile(
            lambda: affine.affine_bwd_dmmat(spts, pos, d, counts, dtype))
        require(round(device[dtype][0]) == 1, f"affine_bwd_dmmat {dtype} "
                f"enqueues {device[dtype][0]} device operations a call, "
                "not 1")
    dtype = torch.bfloat16                     # timed: the flagship's type
    pos, d = inputs[dtype]
    occupied = counts > 0
    live = occupied[:, None] & (pos >= 0)
    rows = int(torch.unique(pos[live]).numel())
    a, width = mmat.shape
    ncells, occ = counts.numel(), int(occupied.sum())
    rest = 4 * ncells + 4 * a * rows + 4 * a * width
    bytes_moved = (4 + 2) * occ * width + rest
    full_tables = (4 + 2) * ncells * width + rest
    ops = 2 * a * int(live.sum())
    return {"name": "affine_bwd_dmmat", "max_abs_err": worst,
            "ms": time_ms(lambda: affine.affine_bwd_dmmat(
                spts, pos, d, counts, dtype)),
            "plain_ms": time_ms(lambda: affine.affine_bwd_dmmat_plain(
                spts, pos, d, counts, dtype)),
            "library_ms": None,
            "device_launches_per_call": device[dtype][0],
            "device_ms": device[dtype][1],
            "device_ms_f32": device[torch.float32][1],
            "bound_ms_full_tables": bound(full_tables, ops)["bound_ms"],
            **bound(bytes_moved, ops)}


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


COUNTERS = (sort.sort_i32, affine.cell_histogram,
            affine.affine_scan_gather, affine.affine_scan_argmax_pair,
            affine.affine_scan_argmax_packed, affine.affine_bwd_dmmat,
            segment.suffix_segment_reduce, affine_aux.affine_segment_scan,
            affine_aux.segment_broadcast_t, sort.sort2_i32)
K1, K3, K2, K4, K5, K6, K7, K8, K9, K10 = COUNTERS
# the shipped configurations the later phases drive as they are written
SHIPPED = {"kitti_sem": kitti_sem_config, "fine_grid": fine_grid_config,
           "camera": camera_config, "custom_local": custom_local_config}


def reset_launches() -> None:
    torch.cuda.synchronize()
    for fn in COUNTERS:
        fn.launches = 0


def read_launches(launched, path: str) -> dict:
    """The launch counts of a path just driven: every wrapper in `launched`
    must have launched, every other one not."""
    torch.cuda.synchronize()
    counts = {fn.__name__: fn.launches for fn in COUNTERS}
    for fn in COUNTERS:
        if fn in launched:
            require(fn.launches > 0, f"{fn.__name__} was not launched on "
                                     f"the {path} path")
        else:
            require(fn.launches == 0, f"{fn.__name__} was launched "
                                      f"{fn.launches} times on the {path} "
                                      "path")
    return counts


def serve(cfg, sd, scans, device, phase="serve", per_scan=None) -> dict:
    """Serve `scans` one by one; `per_scan` {wrapper: launches per scan}
    names every kernel the path must launch, exactly so often."""
    per_scan = {K1: 1, K3: 1, K2: 1} if per_scan is None else per_scan
    engine = GroundInferenceEngine(cfg, sd, device=device)
    warm_s = engine.warmup()
    reset_launches()
    t0 = time.perf_counter()
    outs = [engine.infer(s) for s in scans]
    elapsed = time.perf_counter() - t0
    launches = read_launches(tuple(per_scan), phase)
    for fn, k in per_scan.items():
        require(fn.launches == k * len(scans),
                f"{fn.__name__} launched {fn.launches} times for "
                f"{len(scans)} scans on the {phase} path, not {k} per scan")
    for (elev, labels), scan in zip(outs, scans):
        require(elev.shape == (cfg.ny, cfg.nx) and np.isfinite(elev).all(),
                "elevation finite and (ny, nx)")
        require(labels.shape == (scan.shape[0],)
                and set(np.unique(labels)) <= {-1, 0, 1}, "labels in -1/0/1")
    n_lab = np.concatenate([lab for _, lab in outs])
    return {"launches": launches, "result": {
        "phase": phase, "fused_impl": cfg.fused_impl,
        "compute_dtype": cfg.compute_dtype, "grid": [cfg.ny, cfg.nx],
        "scans": len(scans),
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
    launches = read_launches((K3, K5, K6), "train")
    ops, device_ms = device_profile(lambda: step(state, points, labels))
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
        "device_ops_per_step": ops, "device_ms_per_step": device_ms,
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
        launches = read_launches((K3, K4, K6), "train_f32")
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
    ops, device_ms = device_profile(lambda: step_k(kern, points, labels))
    return {"launches": launches, "result": {
        "phase": "train_parity_f32", "steps": 3, "losses_kernel": lk,
        "losses_plain": lp, "loss_rel_diff": d_loss,
        "loss_rtol": TRAIN_LOSS_RTOL,
        "step1_segnet_param_diff_of_scale": seg,
        "step1_pfn_param_diff_of_scale": pfn, "pfn_rtol": PFN_RTOL,
        "step3_param_diff_of_scale": after, "launches": launches,
        "device_ops_per_step": ops, "device_ms_per_step": device_ms}}


def sorted_path_inputs(engine, padded: torch.Tensor):
    """The tensors the sorted main path hands K7 for one served scan: the
    xyzk stream and its cell ids, and the masked PFN activations."""
    model, cfg = engine.model, engine.cfg
    pts = engine.device_points(padded)
    ctx = pz.bin_points(pts, model.geom)
    cap = cfg.max_points_voxel
    stream = pz.sorted_stream(pts, ctx, model.geom, cap, cfg.exact_point_cap)
    dec = pz.fused_frontend_sorted(pts, ctx, model.geom, cap,
                                   with_distance=cfg.with_distance,
                                   exact_point_cap=cfg.exact_point_cap,
                                   reference=True)[0]
    with torch.no_grad():
        acts = model.voxel_feature_extractor.pfn_layers[0].activate_flat(dec)
    return (stream.xyzk.contiguous(), stream.sorted_cell.contiguous(),
            pz.masked_activations(acts, stream.kept))


def k7_case(x, cell, op: str, what: str) -> float:
    """K7 vs its plain version on one input: equal to the bit (the plain
    version sums in the kernel's order; max is exact).  Returns the max
    |err|."""
    got = segment.suffix_segment_reduce(x, cell, op, 1)
    torch.cuda.synchronize()
    want = segment.suffix_segment_reduce_plain(x, cell, op, 1)
    err = float((got.float() - want.float()).abs().max())
    require(torch.equal(got, want), f"K7 {op} {what}: differs in "
            f"{int((got != want).sum())} entries, max |err| {err}")
    return err


def check_segment(xyzk, cell, masked) -> dict:
    """K7 at the sorted frontend's shapes (the (N, 64) activation max, the
    (N, 4) xyzk sums forward and flipped with negated ids) and on edge
    cases: one row, one cell throughout, a drop run over most tiles (both
    chains of whole-run tiles longer than the look-back's 32-tile window),
    N not a multiple of the tile, bf16 max; repeated calls give the same
    bits.  One kernel and at most one memset a call (torch.profiler)."""
    n = cell.shape[0]
    one = torch.zeros_like(cell)
    drop = cell.clone()
    drop[int(0.4 * n):] = int(cell.max()) + 1
    odd = 70_001
    fx, fc = torch.flip(xyzk, (0,)), torch.flip(-cell, (0,))
    cases = [(masked, cell, "max", "kitti acts"),
             (masked.bfloat16(), cell, "max", "kitti acts bf16"),
             (xyzk, cell, "sum", "kitti xyzk"),
             (fx, fc, "sum", "kitti xyzk flipped, negated ids"),
             (masked[:1], cell[:1], "max", "one row"),
             (xyzk[:1], cell[:1], "sum", "one row"),
             (masked, one, "max", "one cell"), (xyzk, one, "sum", "one cell"),
             (masked, drop, "max", "drop run"), (xyzk, drop, "sum", "drop run"),
             (masked[:odd], cell[:odd], "max", f"N={odd}"),
             (xyzk[:odd], cell[:odd], "sum", f"N={odd}")]
    worst = max(k7_case(x.contiguous(), c.contiguous(), op, what)
                for x, c, op, what in cases)
    for x, c, op in ((xyzk, cell, "sum"), (masked, drop, "max"),
                     (xyzk, one, "sum")):
        first = segment.suffix_segment_reduce(x, c, op, 1)
        require(all(torch.equal(first, segment.suffix_segment_reduce(
            x, c, op, 1)) for _ in range(5)), f"K7 {op} differs between runs")

    def k7(x, op):
        return lambda: segment.suffix_segment_reduce(x, cell, op)

    sum_ops, sum_device_ms = device_profile(k7(xyzk, "sum"))
    launches, device_ms = device_profile(k7(masked, "max"))
    require(max(launches, sum_ops) <= 2, f"K7 enqueues {launches} (max) / "
            f"{sum_ops} (sum) device operations a call, more than 2")
    width = masked.shape[1]
    emit({"phase": "kernel_k7_sum", "shape": list(xyzk.shape),
          "sum_ms": time_ms(k7(xyzk, "sum")),
          "device_launches_per_call": sum_ops, "device_ms": sum_device_ms,
          **bound(2 * 4 * xyzk.numel() + 4 * n, xyzk.numel())})
    return {"name": "suffix_segment_reduce", "max_abs_err": worst,
            "ms": time_ms(k7(masked, "max")),
            "plain_ms": time_ms(lambda: segment.suffix_segment_reduce_plain(
                masked, cell, "max"), reps=5, warm=1),
            "library_ms": None, "shape": [n, width],
            "device_launches_per_call": launches, "device_ms": device_ms,
            **bound(2 * 4 * n * width + 4 * n, n * width)}


def parity_vs_scatter(cfg, sd, scans, device, phase: str) -> dict:
    """f32 / 'highest', TF32 off: cfg's impl ('sorted', or 'affine' on a
    grid whose packed key overflows) on its kernel path against its plain
    path, and against the scatter impl, on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = cfg.replace(compute_dtype="float32", matmul_precision="highest")
    eng = GroundInferenceEngine(cfg32, sd, device=device)
    eng_sc = GroundInferenceEngine(cfg32.replace(fused_impl="scatter"), sd,
                                   device=device)
    elev_tol = 1e-4
    worst = {"canvas": 0.0, "elevation": 0.0,
             "canvas_vs_scatter": 0.0, "elevation_vs_scatter": 0.0}
    close, labels_apart = True, 0
    for scan in scans:
        padded = torch.from_numpy(eng._prepare(scan)[0])
        pts = eng.device_points(padded)
        with torch.no_grad():
            ck = eng.model.canvas(pts[None])
            cp = eng.model.canvas(pts[None], reference=True)
            cs = eng_sc.model.canvas(pts[None])
        (ek, lk), (ep, _) = eng.run(padded), eng.run(padded, reference=True)
        es, ls = eng_sc.run(padded)
        for name, d in (("canvas", ck - cp), ("elevation", ek - ep),
                        ("canvas_vs_scatter", ck - cs),
                        ("elevation_vs_scatter", ek - es)):
            worst[name] = max(worst[name], float(d.abs().max()))
        close &= bool(torch.allclose(ck, cs, rtol=IMPL_RTOL, atol=IMPL_ATOL))
        labels_apart += int((lk != ls).sum())
    result = {"phase": phase, "fused_impl": cfg.fused_impl,
              "grid": [cfg.ny, cfg.nx], "scans": len(scans),
              "canvas_atol": 1e-5, "elevation_atol": elev_tol,
              "impl_canvas_rtol": IMPL_RTOL, "impl_canvas_atol": IMPL_ATOL,
              "impl_elevation_atol": IMPL_ELEV_ATOL, "max_abs_diff": worst,
              "canvas_close_to_scatter": close,
              "labels_vs_scatter_differ": labels_apart}
    emit(result)
    require(worst["canvas"] <= 1e-5, f"{phase}: canvas kernel vs plain "
                                     f"{worst['canvas']}")
    require(worst["elevation"] <= elev_tol, f"{phase}: elevation kernel vs "
                                            f"plain {worst['elevation']}")
    require(close, f"{phase}: canvas vs scatter outside rtol {IMPL_RTOL} / "
                   f"atol {IMPL_ATOL}: {worst}")
    require(worst["elevation_vs_scatter"] <= IMPL_ELEV_ATOL,
            f"{phase}: elevation vs scatter "
            f"{worst['elevation_vs_scatter']}")
    return result


def fine_path_pairs(engine, padded: torch.Tensor):
    """The (local cell, stream iota) pairs the fine_grid affine main path
    hands K10 for one served scan."""
    pts = engine.device_points(padded)
    geom = engine.model.geom
    ctx = pz.bin_points(pts, geom)
    local = torch.where(ctx.valid, ctx.cell, geom.num_cells_3d)
    return local.contiguous(), torch.arange(
        pts.shape[0], dtype=torch.int32, device=pts.device)


def check_sort2(hi: torch.Tensor, lo: torch.Tensor, rng) -> dict:
    """K10 (the cluster radix sort up to RADIX_MAX_PAIRS pairs, the bitonic
    network above) against its plain version and np.lexsort on the
    fine_grid main path's pairs and edge cases: full-range words with
    INT32_MAX and INT32_MIN among real pairs, negative hi, repeated lo, lo
    in order and out of order only across two CTAs, pairs equal to the
    bitonic pad, the capacity and 2^19 pairs (bitonic)."""
    dev = hi.device
    cap = _ext.function("cluster_radix_sort_capacity")(8)
    require(cap == sort.RADIX_MAX_PAIRS, f"K10 capacity on this card {cap}, "
                                         f"ops/sort.py {sort.RADIX_MAX_PAIRS}")
    cases = {"fine_grid_pairs": (hi, lo)}
    for n in (1, 2, 255, 257, 4097, 131_072, sort.RADIX_MAX_PAIRS, 1 << 19):
        words = rng.integers(-2**31, 2**31 - 1, (2, n), endpoint=True)
        words[0, ::3] = 2**31 - 1
        words[0, 1::5] = -2**31
        words[1, ::4] = words[1, 0]
        cases[f"full_range_{n}"] = tuple(
            torch.from_numpy(w.astype(np.int32)).to(dev) for w in words)
    neg = rng.integers(-2**31, 0, 102_400)
    cases["negative_hi_repeated_lo"] = tuple(
        torch.from_numpy(w.astype(np.int32)).to(dev)
        for w in (neg, rng.integers(-3, 3, 102_400)))
    # lo in order skips lo's passes; one descent across the first CTA
    # boundary (16 CTAs of 6400) must bring them back
    swapped = lo.clone()
    swapped[6399], swapped[6400] = lo[6400], lo[6399]
    cases["lo_descends_across_ctas"] = (hi, swapped)
    cases["sorted_lo_repeats"] = (hi, torch.from_numpy(np.sort(
        rng.integers(-3000, 3000, hi.numel())).astype(np.int32)).to(dev))
    pad = torch.full((1000,), 2**31 - 1, dtype=torch.int32, device=dev)
    cases["all_pad_pairs"] = (pad, pad.clone())
    for name, (h, l_) in cases.items():
        before = sort.sort2_i32.launches
        got = sort.sort2_i32(h, l_)
        torch.cuda.synchronize()
        require(sort.sort2_i32.launches == before + 1,
                f"K10 {name}: {sort.sort2_i32.launches - before} launches")
        want = sort.sort2_i32_plain(h, l_)
        hn, ln = h.cpu().numpy(), l_.cpu().numpy()
        order = np.lexsort((ln, hn))
        for g, w, ref in zip(got, want, (hn[order], ln[order])):
            require(torch.equal(g, w) and np.array_equal(g.cpu().numpy(),
                                                         ref),
                    f"K10 sort2 {name}: differs in "
                    f"{int((g != w).sum())} entries")
    launches, device_ms = device_profile(lambda: sort.sort2_i32(hi, lo))
    require(round(launches) == 1, f"K10 enqueues {launches} kernels a call")
    n = hi.numel()
    m = sort.padded_size(n)
    bitonic = _ext.function("bitonic_sort2_i32")
    keys = torch.empty((m,), dtype=torch.int64, device=dev)
    hi_out, lo_out = torch.empty_like(hi), torch.empty_like(lo)
    stream = _ext.stream_ptr(hi)

    def earlier():
        return bitonic(hi.data_ptr(), lo.data_ptr(), keys.data_ptr(),
                       hi_out.data_ptr(), lo_out.data_ptr(), n, m, stream)

    _ext.check(earlier(), "bitonic_sort2_i32")

    def library():
        order = torch.sort(hi, stable=True)
        return order.values, lo[order.indices]

    lib_launches, lib_device_ms = device_profile(library)
    return {"name": "cluster_radix_sort2_i32", "max_abs_err": 0,
            "ms": time_ms(lambda: sort.sort2_i32(hi, lo)),
            "earlier_ms": time_ms(earlier),
            "earlier": "bitonic_sort2_i32 (csrc/bitonic_sort2.cu), padded "
                       "to a power of two",
            "plain_ms": time_ms(lambda: sort.sort2_i32_plain(hi, lo),
                                reps=3, warm=1),
            "library_ms": time_ms(library),
            "library": "torch.sort(hi, stable=True) and the gather of lo",
            "device_launches_per_call": launches, "device_ms": device_ms,
            "library_device_launches_per_call": lib_launches,
            "library_device_ms": lib_device_ms,
            "capacity": cap, "shape": [n], **bound(4 * 4 * n, 0)}


def main_path_pts8(spts, local_s, mmat, cap: int, ncells: int):
    """The kitti_sem serving stream in K8's layout: cell-sorted ids, pts8
    [x, y, z, kept (rank < cap), intensity, 0, 0, 0] and mmat8 with the
    PFN's rows at the same places, row 3 zero."""
    cell = local_s[0].contiguous()
    pos = torch.arange(cell.numel(), device=cell.device)
    start = torch.searchsorted(cell, cell)
    kept = ((pos - start) < cap) & (cell < ncells)
    pts8 = torch.zeros((cell.numel(), 8), device=cell.device)
    pts8[:, :3] = spts[:, :3]
    pts8[:, 3] = kept.float()
    pts8[:, 4:spts.shape[1] + 1] = spts[:, 3:]
    mmat8 = torch.zeros((8, mmat.shape[1]), device=mmat.device)
    mmat8[:3] = mmat[:3]
    mmat8[4:mmat.shape[0] + 1] = mmat[3:]
    return cell, pts8, mmat8.contiguous()


def k8_case(cell, pts8, mmat8, dtype, what: str) -> None:
    """K8 vs its plain version on one input: run_tot and run_max equal to
    the bit (the plain version sums in the kernel's order)."""
    got = affine_aux.affine_segment_scan(cell, pts8, mmat8, out_dtype=dtype,
                                         chunk=1)
    torch.cuda.synchronize()
    want = affine_aux.affine_segment_scan_plain(cell, pts8, mmat8,
                                                out_dtype=dtype, chunk=1)
    for name, g, w in zip(("run_tot", "run_max"), got, want):
        require(torch.equal(g, w), f"K8 {what} {dtype}: {name} differs in "
                f"{int((g != w).sum())} entries, max |err| "
                f"{float((g.float() - w.float()).abs().max())}")


def same_bits(fn, what: str, calls: int = 20) -> None:
    """`calls` back-to-back calls of fn() give the first call's bits."""
    first = fn()
    for _ in range(calls - 1):
        again = fn()
        require(all(torch.equal(a, b) for a, b in zip(first, again)),
                f"{what}: a repeated call differs")


def check_k8(setup, main_path) -> dict:
    """K8 at the profile's shape ((102 400, 8) x (8, 64), chunk 1024), on
    the kitti_sem serving stream, and on edge cases: one row, one cell
    throughout, one run over 6 tiles, rows masked at random, N not a
    multiple of the kernel's tile; f32 and bf16 out, with the JAX kernel's max_prefix (which the
    port's complete prefix ignores) the same bits; 20 calls the same bits
    and at most 2 device operations a call (one kernel)."""
    cell, pts8, mmat8 = setup.cell_k, setup.pts8, setup.mmat8
    one = torch.zeros_like(cell)
    odd = 70_001
    tile = affine_aux.k8_layout(cell.numel(), 4 + mmat8.shape[1])[0]
    long_run = cell.clone()
    long_run[1000:1000 + 5 * tile + 77] = cell[1000]
    long_run = torch.sort(long_run).values
    # a tenth of the rows masked anywhere, so a run's prefix can be the
    # mask value -3e38 (rounded in bf16)
    masked = pts8.clone()
    masked[torch.from_numpy(np.random.default_rng(9).random(
        cell.numel()) < 0.1).to(cell.device), 3] = 0.0
    cases = [((cell, pts8, mmat8), "profile"), (main_path, "kitti stream"),
             ((cell, masked, mmat8), "rows masked at random"),
             ((cell[:1], pts8[:1], mmat8), "one row"),
             ((one, pts8, mmat8), "one cell"),
             ((long_run, pts8, mmat8), "one run over 6 tiles"),
             ((cell[:odd], pts8[:odd], mmat8), f"N={odd}")]
    for dtype in (torch.bfloat16, torch.float32):
        for (c, p, m), what in cases:
            k8_case(c.contiguous(), p.contiguous(), m, dtype, what)
    capped = affine_aux.affine_segment_scan(cell, pts8, mmat8,
                                            out_dtype=torch.bfloat16,
                                            chunk=1024, max_prefix=100)
    full = affine_aux.affine_segment_scan(cell, pts8, mmat8,
                                          out_dtype=torch.bfloat16,
                                          chunk=1024)
    require(all(torch.equal(a, b) for a, b in zip(capped, full)),
            "K8 max_prefix changed the result")
    n, width = pts8.shape[0], mmat8.shape[1]

    def kern(dtype, c=cell):
        return lambda: affine_aux.affine_segment_scan(
            c, pts8, mmat8, out_dtype=dtype, chunk=1024)

    device = {}
    for dtype in (torch.bfloat16, torch.float32):
        for c, what in ((cell, "profile"), (one, "one cell")):
            same_bits(kern(dtype, c), f"K8 {what} {dtype}")
        device[dtype] = device_profile(kern(dtype))
        require(round(device[dtype][0]) <= 2, f"affine_segment_scan {dtype} "
                f"enqueues {device[dtype][0]} device operations a call")
    f32_ms = time_ms(kern(torch.float32))
    emit({"phase": "kernel_k8_f32", "shape": [n, 8, width], "ms": f32_ms,
          "device_ms": device[torch.float32][1],
          **bound(n * (4 + 32 + 16 + 4 * width) + 32 * width,
                  n * (17 * width + 8))})
    return {"name": "affine_segment_scan", "max_abs_err": 0.0,
            "ms": time_ms(kern(torch.bfloat16)),
            "plain_ms": time_ms(lambda: affine_aux.affine_segment_scan_plain(
                cell, pts8, mmat8, out_dtype=torch.bfloat16, chunk=1024),
                reps=2, warm=1),
            "library_ms": None,
            "library": "none: no PyTorch call fuses the product with a "
                       "segmented prefix sum and max at every row",
            "device_launches_per_call": device[torch.bfloat16][0],
            "device_ms": device[torch.bfloat16][1],
            "device_ms_f32": device[torch.float32][1],
            "shape": [n, 8, width],
            **bound(n * (4 + 32 + 16 + 2 * width) + 32 * width,
                    n * (17 * width + 8))}


def check_k9(setup) -> dict:
    """K9 at probe_train.py's (128, 1 605 632) table and on edge cases: the
    payload at run starts (every row gets its run's payload), one row, one
    cell throughout, runs that straddle every tile boundary, one channel;
    equal to the plain version to the bit (max is exact); 20 calls the
    same bits and at most 2 device operations a call (one kernel)."""
    cell, vals = setup.broadcast_inputs()
    payload = setup.broadcast_payload()
    one = setup.broadcast_one_cell()
    n = cell.numel()
    # runs of 1000 rows starting 500 rows before each thousand: no run
    # starts on a multiple of the kernel's tile height
    straddle = ((torch.arange(n, device=cell.device) + 500) // 1000).to(
        torch.int32)
    tile = affine_aux.k9_layout(n, vals.shape[0])[0]
    starts = torch.nonzero(straddle[1:] != straddle[:-1])[:, 0] + 1
    require(not bool((starts % tile == 0).any()),
            "K9 straddling case: a run starts on a tile boundary")
    cases = [(cell, vals, "profile"), (cell, payload, "payload"),
             (cell[:1], vals[:, :1], "one row"), (one, vals, "one cell"),
             (straddle, vals, "runs straddling every tile"),
             (cell, vals[:1], "one channel")]
    for c, v, what in cases:
        got = affine_aux.segment_broadcast_t(c, v.contiguous(), chunk=1)
        torch.cuda.synchronize()
        want = affine_aux.segment_broadcast_t_plain(c, v.contiguous(),
                                                    chunk=1)
        require(torch.equal(got, want), f"K9 {what}: differs in "
                f"{int((got != want).sum())} entries")
        del got, want
    first = torch.searchsorted(cell, cell)
    require(torch.equal(affine_aux.segment_broadcast_t(cell, payload),
                        payload[:, first]), "K9 payload not broadcast")
    for c, what in ((cell, "profile"), (one, "one cell")):
        same_bits(lambda c=c: (affine_aux.segment_broadcast_t(c, vals),),
                  f"K9 {what}")
    launches, device_ms = device_profile(
        lambda: affine_aux.segment_broadcast_t(cell, vals, chunk=2048))
    require(round(launches) <= 2, f"segment_broadcast_t enqueues {launches} "
                                  "device operations a call")
    width = vals.shape[0]
    return {"name": "segment_broadcast_t", "max_abs_err": 0.0,
            "ms": time_ms(lambda: affine_aux.segment_broadcast_t(
                cell, vals, chunk=2048), reps=5, warm=1),
            "plain_ms": time_ms(lambda: affine_aux.segment_broadcast_t_plain(
                cell, vals, chunk=2048), reps=1, warm=1),
            "library_ms": None,
            "library": "none: PyTorch has no segmented running max "
                       "(torch.cummax runs over the whole row)",
            "device_launches_per_call": launches, "device_ms": device_ms,
            "shape": [width, n],
            **bound(4 * n + 2 * 4 * width * n, width * n)}


def serve_many(runs, device) -> dict:
    """`infer_many` bursts: one fused call at B=K per burst (K3 and K2
    once, K1 and K10 never); the batched canvas equals the per-scan ones
    to the bit, and each elevation matches per-scan `infer` within
    SERVE_MANY_ELEV_ATOL (the SegNet convolves a batch in another order)."""
    out, paths = {"phase": "serve_many"}, {}
    for name, cfg, sd, scans in runs:
        engine = GroundInferenceEngine(cfg, sd, device=device)
        engine.infer_many(scans)                     # warm: cuDNN plans
        reset_launches()
        t0 = time.perf_counter()
        many = engine.infer_many(scans)
        elapsed = time.perf_counter() - t0
        paths[f"serve_many_{name}"] = read_launches((K3, K2),
                                                    f"serve_many_{name}")
        require(K3.launches == 1 and K2.launches == 1,
                f"serve_many {name}: K3/K2 launched {K3.launches}/"
                f"{K2.launches} times for one call")
        padded = torch.from_numpy(np.stack([engine._prepare(s)[0]
                                            for s in scans]))
        with torch.no_grad():
            pts = engine.device_points(padded)
            batched = engine.model.canvas(pts)
            single = torch.cat([engine.model.canvas(p[None]) for p in pts])
        require(torch.equal(batched, single),
                f"serve_many {name}: batched canvas differs from per-scan")
        gap = 0.0
        for (eb, lb), scan in zip(many, scans):
            e1, l1 = engine.infer(scan)
            gap = max(gap, float(np.abs(eb - e1).max()))
            require(lb.shape == l1.shape and np.isfinite(eb).all(),
                    f"serve_many {name}: shapes")
        require(gap <= SERVE_MANY_ELEV_ATOL,
                f"serve_many {name}: elevation vs per-scan infer {gap}")
        out[name] = {"scans": len(scans), "grid": [cfg.ny, cfg.nx],
                     "seconds": elapsed, "scans_per_s": len(scans) / elapsed,
                     "elevation_vs_infer": gap}
    out["elevation_atol"] = SERVE_MANY_ELEV_ATOL
    return {"launches": paths, "result": out}


def train_fine_grid(cfg, sd, rng, device) -> dict:
    """fine_grid trained through 'affine' at B=2 (bf16): the stable
    batched sort (no K10), K3, K5 and K6; finite losses, every parameter
    moves; steps/s."""
    points, labels = synthetic_labelled_batch(cfg, rng, TRAIN_BATCH,
                                              cfg.num_points)
    state = train.create_train_state(cfg, 100, state_dict=sd, device=device)
    step = train.make_train_step(cfg)
    before = params_of(state)
    state, loss = step(state, points, labels)           # warm: cuDNN plans
    reset_launches()
    t0 = time.perf_counter()
    losses = [step(state, points, labels)[1] for _ in range(3)]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_launches((K3, K5, K6), "train_fine_grid_affine")
    losses = [float(v) for v in losses]
    require(all(np.isfinite(losses)), f"fine_grid losses {losses}")
    moved = {k: bool((v != before[k]).any())
             for k, v in params_of(state).items()}
    require(all(moved.values()), "parameters that did not move: "
            f"{[k for k, v in moved.items() if not v]}")
    return {"launches": launches, "result": {
        "phase": "train_fine_grid_affine", "batch": TRAIN_BATCH,
        "grid": [cfg.ny, cfg.nx], "steps": 3, "losses": losses,
        "steps_per_s": 3 / elapsed, "launches": launches,
        "params_moved": len(moved)}}


def profile_phase(setup) -> dict:
    """The affine stage profile's K8, K10 and K9 cases, few repetitions."""
    reset_launches()
    lines = profile_affine.run(profile_affine.K8_CASES
                               + profile_affine.K10_CASES
                               + profile_affine.K9_CASES, reps=3,
                               setup=setup)
    launches = read_launches((K8, K9, K10, K3, K2), "profile_affine")
    return {"launches": launches, "result": {
        "phase": "profile_affine", "cases": lines, "launches": launches}}


def pfn_norm_state(state) -> dict:
    norm = state.model.voxel_feature_extractor.pfn_layers[0].norm
    return {k: v.detach().clone() for k, v in norm.state_dict().items()}


def train_scatter(rng, device) -> dict:
    """kitti_sem as shipped ('scatter', float32, 'highest'), B=2, three
    steps with use_norm off and on: finite losses, every parameter moves,
    under use_norm the PFN's running statistics move; no kernel launches."""
    out = {"phase": "train_scatter"}
    for use_norm in (False, True):
        cfg = SHIPPED["kitti_sem"]().replace(use_norm=use_norm)
        points, labels = synthetic_labelled_batch(cfg, rng, TRAIN_BATCH,
                                                  cfg.num_points)
        state = train.create_train_state(
            cfg, 100, state_dict=init_state_dict(cfg, seed=SEED),
            device=device)
        step = train.make_train_step(cfg)
        before = params_of(state)
        norm_before = pfn_norm_state(state) if use_norm else {}
        reset_launches()
        t0 = time.perf_counter()
        losses = [float(step(state, points, labels)[1]) for _ in range(3)]
        elapsed = time.perf_counter() - t0
        launches = read_launches((), "train_scatter")
        require(all(np.isfinite(losses)), f"scatter losses {losses}")
        moved = {k: bool((v != before[k]).any())
                 for k, v in params_of(state).items()}
        require(all(moved.values()), "parameters that did not move: "
                f"{[k for k, v in moved.items() if not v]}")
        if use_norm:
            after = pfn_norm_state(state)
            for key in ("running_mean", "running_var", "weight", "bias"):
                require(not torch.equal(after[key], norm_before[key]),
                        f"PFN norm.{key} did not move")
        out[f"use_norm_{use_norm}"] = {
            "losses": losses, "steps_per_s": 3 / elapsed,
            "params_moved": len(moved)}
    return {"launches": launches, "result": out}


def presets(rng, device) -> dict:
    """camera, custom_local and fine_grid as shipped: one served scan, one
    B=2 train step with use_norm off and on."""
    out = {"phase": "presets"}
    reset_launches()
    for name in ("camera", "custom_local", "fine_grid"):
        cfg = SHIPPED[name]()
        sd = init_state_dict(cfg, seed=SEED)
        engine = GroundInferenceEngine(cfg, sd, device=device)
        elev, _ = engine.infer(synthetic_scan(cfg, rng, cfg.num_points))
        require(elev.shape == (cfg.ny, cfg.nx) and np.isfinite(elev).all(),
                f"{name}: elevation finite and (ny, nx)")
        losses = {}
        for use_norm in (False, True):
            c = cfg.replace(use_norm=use_norm)
            state = train.create_train_state(
                c, 10, state_dict=init_state_dict(c, seed=SEED),
                device=device)
            _, loss = train.make_train_step(c)(
                state, *synthetic_labelled_batch(c, rng, TRAIN_BATCH,
                                                 c.num_points))
            losses[f"use_norm_{use_norm}"] = float(loss)
        require(all(np.isfinite(list(losses.values()))),
                f"{name}: train losses {losses}")
        out[name] = {"grid": [cfg.ny, cfg.nx], "fused_impl": cfg.fused_impl,
                     "elevation_mean": float(elev.mean()), **losses}
    out["launches"] = read_launches((), "presets")
    return out


REPLACES = {
    "cluster_radix_sort_i32": ("gndnet_tpu/ops/pallas_sort.py:230",
                               "gndnet_tpu_torch/csrc/cluster_radix_sort.cu"),
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
    "suffix_segment_reduce": ("gndnet_tpu/ops/pallas_segment.py:117",
                              "gndnet_tpu_torch/csrc/suffix_segment.cu"),
    "cluster_radix_sort2_i32": ("gndnet_tpu/ops/pallas_sort.py:285",
                                "gndnet_tpu_torch/csrc/cluster_radix_sort.cu"),
    "affine_segment_scan": ("gndnet_tpu/ops/pallas_affine.py:143",
                            "gndnet_tpu_torch/csrc/prefix_segment.cu"),
    "segment_broadcast_t": ("gndnet_tpu/ops/pallas_affine.py:595",
                            "gndnet_tpu_torch/csrc/prefix_segment.cu"),
}
# kernel row -> (wrapper, the path whose run gives its `launches`)
WRAPPER = {"cluster_radix_sort_i32": ("sort_i32", "serve"),
           "cell_histogram_i32": ("cell_histogram", "serve"),
           "affine_scan_gather": ("affine_scan_gather", "serve"),
           "affine_scan_argmax_pair": ("affine_scan_argmax_pair",
                                       "train_f32"),
           "affine_scan_argmax_packed": ("affine_scan_argmax_packed",
                                         "train"),
           "affine_bwd_dmmat": ("affine_bwd_dmmat", "train"),
           "suffix_segment_reduce": ("suffix_segment_reduce",
                                     "serve_sorted"),
           "cluster_radix_sort2_i32": ("sort2_i32",
                                       "serve_fine_grid_affine"),
           "affine_segment_scan": ("affine_segment_scan", "profile_affine"),
           "segment_broadcast_t": ("segment_broadcast_t",
                                   "profile_affine")}


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
    cfg = serving_config(kitti_sem_config())
    kernels = run(cfg, cfg.num_points, "cuda")
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


def run(cfg, n_points: int, device) -> list:
    """Phases 3-18 on `device`; returns the kernels line's entries."""
    rng = np.random.default_rng(SEED)
    sd = init_state_dict(cfg, seed=SEED)
    set_bn_stats(sd, rng)
    scans = [synthetic_scan(cfg, rng, n_points) for _ in range(6)]

    probe = GroundInferenceEngine(cfg, sd, device=device)
    padded, _ = probe._prepare(scans[0])
    key, local_s, spts, mmat = main_path_inputs(probe,
                                                torch.from_numpy(padded))
    cap = cfg.max_points_voxel
    scans16 = scans + [synthetic_scan(cfg, rng, n_points) for _ in range(10)]
    fine_aff = serving_config(SHIPPED["fine_grid"]())
    fine_aff_sd = init_state_dict(fine_aff, seed=SEED)
    set_bn_stats(fine_aff_sd, rng)
    fine_aff_scans = [synthetic_scan(fine_aff, rng, n_points)
                      for _ in range(4)]
    fine_probe = GroundInferenceEngine(fine_aff, fine_aff_sd, device=device)
    rows = [check_sort(key, rng),
            check_hist(local_s, cfg.ny, cfg.nx, rng,
                       burst_ids(probe, scans16),
                       (burst_ids(fine_probe, fine_aff_scans[:1]),
                        fine_aff.ny, fine_aff.nx)),
            check_scan(spts, local_s, cfg.ny, cfg.nx, mmat, cap)]
    batch, _ = synthetic_labelled_batch(cfg, rng, TRAIN_BATCH, n_points)
    tpts, tstarts, tcounts, tmmat = train_inputs(cfg, sd, batch)
    rows += [check_argmax(tpts, tstarts, tcounts, tmmat, cap, False, rng),
             check_argmax(tpts, tstarts, tcounts, tmmat, cap, True, rng),
             check_dmmat(tpts, tstarts, tcounts, tmmat, cap, rng)]
    sorted_cfg = cfg.replace(fused_impl="sorted")
    probe = GroundInferenceEngine(sorted_cfg, sd, device=device)
    rows.append(check_segment(*sorted_path_inputs(
        probe, torch.from_numpy(probe._prepare(scans[0])[0]))))
    probe = fine_probe
    rows.append(check_sort2(*fine_path_pairs(probe, torch.from_numpy(
        probe._prepare(fine_aff_scans[0])[0])), rng))
    setup = profile_affine.Setup(cfg, fine_aff, n_points)
    rows += [check_k8(setup, main_path_pts8(spts, local_s, mmat, cap,
                                            cfg.ny * cfg.nx)),
             check_k9(setup)]
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

    served = serve(sorted_cfg, sd, scans, device, "serve_sorted", {K7: 3})
    paths["serve_sorted"] = served["launches"]
    emit(served["result"])
    shipped = SHIPPED["kitti_sem"]()
    served = serve(shipped, init_state_dict(shipped, seed=SEED), scans[:3],
                   device, "serve_scatter", {})
    paths["serve_scatter"] = served["launches"]
    emit(served["result"])
    fine = SHIPPED["fine_grid"]()
    fine_sd = init_state_dict(fine, seed=SEED)
    fine_scans = [synthetic_scan(fine, rng, n_points) for _ in range(2)]
    for impl, per_scan in (("scatter", {}), ("sorted", {K7: 3})):
        served = serve(fine.replace(fused_impl=impl), fine_sd, fine_scans,
                       device, f"serve_fine_grid_{impl}", per_scan)
        paths[f"serve_fine_grid_{impl}"] = served["launches"]
        emit(served["result"])
    parity_vs_scatter(sorted_cfg, sd, scans[:2], device, "parity_sorted")
    trained = train_scatter(rng, device)
    paths["train_scatter"] = trained["launches"]
    emit(trained["result"])
    shipped_presets = presets(rng, device)
    paths["presets"] = shipped_presets["launches"]
    emit(shipped_presets)

    served = serve(fine_aff, fine_aff_sd, fine_aff_scans, device,
                   "serve_fine_grid_affine", {K10: 1, K3: 1, K2: 1})
    paths["serve_fine_grid_affine"] = served["launches"]
    emit(served["result"])
    parity_vs_scatter(fine_aff, fine_aff_sd, fine_aff_scans[:2], device,
                      "parity_fine_grid")
    trained = train_fine_grid(fine_aff, fine_aff_sd, rng, device)
    paths["train_fine_grid_affine"] = trained["launches"]
    emit(trained["result"])
    many = serve_many([("kitti_sem_K4", cfg, sd, scans[:4]),
                       ("kitti_sem_K16", cfg, sd, scans16),
                       ("fine_grid_K2", fine_aff, fine_aff_sd,
                        fine_aff_scans[:2])], device)
    paths.update(many["launches"])
    emit(many["result"])
    profiled = profile_phase(setup)
    paths["profile_affine"] = profiled["launches"]
    emit(profiled["result"])

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
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library": row.get("library"),
            **{k: row[k] for k in ("earlier_ms", "earlier",
                                   "device_launches_per_call", "device_ms",
                                   "device_ms_f32", "bound_ms_full_tables",
                                   "library_device_launches_per_call",
                                   "library_device_ms", "capacity",
                                   "counts_ms", "counts_device_ms",
                                   "cluster", "cluster_sizes")
               if k in row}})
    return kernels


if __name__ == "__main__":
    sys.exit(main())
