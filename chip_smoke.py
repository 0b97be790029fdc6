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
 19. serve_aot: the warm start.  `aot_save` then `aot_load` in a fresh
     engine, which captures one CUDA graph of `run` for the padded
     kitti_sem shape, for 'affine' (bf16) and 'sorted' (graph outputs
     bit-equal to the eager engine's `run` over 20 scans) and 'scatter' as
     shipped (within IMPL_ELEV_ATOL: atomics); no wrapper counts a
     replay, torch.profiler's device records of a replay show K1, K3 and
     K2 once ('affine') or K7 three times ('sorted') and no other kernel
     of K1-K10, a scan of another bucket runs eagerly (K1-K3 counted);
     host-clock scans/s eager against graph, device ms a scan, busy share;
 20. pipelined: `infer_pipelined(depth=3)` of 32 scans on the graph
     engine, bit-equal to `infer`; scans/s against sequential `infer`;
 21. streaming: `StreamingEngine` on the graph engine with the native
     mailbox (required), 16 distinct scans fed forward (no errors, the last
     result `infer`'s of the last scan), `replay_device` free-wheeling (no
     drops) and at 55 Hz, and `replay` of the 16 scans: sustained Hz, drop
     share, latency p50 / p99;
 22. generate: a SemanticKITTI-layout sequence of 4 synthetic 100 000-point
     scans (ground 40/48/72, obstacles 10/50, 2% labelled 0/1) through
     `generate_dataset` on the card with one worker: every frame written
     with num_points rows and a finite 100x100 grid, the first frame's
     grid within GEN_GRID_ATOL of a CPU run's; seconds a frame;
 23. evaluate: `evaluate_semantic_kitti` on that sequence at the serving
     settings, K1, K3 and K2 once a frame, IoU / precision / recall / MSE
     and ms a frame split between the engine and the host metrics; at
     float32 / 'highest' the kernel path against the plain path (per-frame
     metrics from each, IoU within EVAL_IOU_ATOL, differing labels within
     EVAL_ELEV_ATOL of the threshold); `evaluate_height_rmse` on the
     generated frames, K3 and K2 once a batch; the CLI
     `python -m gndnet_tpu_torch.scripts.evaluate --config kitti_sem`;
 24. train_augmented: sparse_32beam (50 000 points) frames generated from
     the sequence, B=2, bf16 'affine', `make_train_step(augment=True)`:
     5 steps fed by StreamingLoader and prefetch_to_device, K3, K5 and K6
     once a step, losses finite; ms a step, augmented against unaugmented
     on the same device batches;
 25. pillar_path: the reference-style path at kitti_sem as shipped
     (f32, 'highest', TF32 off), B=2 scans: `pillarize_batch` + `forward`
     against the fused 'scatter' path (canvas within 1e-5 of scale,
     elevation within IMPL_ELEV_ATOL), no K1-K10 launch; a pillar-path
     train step with use_norm off and on, the use_norm invariant (fused
     step against pillar step: loss rel 1e-4, parameters rtol 1e-3); a
     two-layer PFN (32, 64) forward and step, every parameter moved;
     fine_grid's `pillarize` (n_pillars == max_voxels, the earliest cells);
     ms and peak device memory;
 26. loss_scaling: a kitti_sem B=2 bf16 'affine' step with loss scaling
     (K3, K5, K6 once) against the unscaled step, and a forced overflow
     that is skipped (nothing moves but the halved scale and the step
     count);
 27. cli: on phase 22's pairs, `train --impl affine --bf16 --epochs 1 -s`
     (K5, K6 once a step; K3 once a step and a validation batch; K2 once a
     validation batch), `-e` resumed, `predict` from the checkpoint
     directory under a serving YAML (K1, K3, K2 once; equal to the
     engine), `convert_checkpoint` both ways bit-equal;
 28. parallel: the multi-GPU paths in two rank processes (gloo on one
     card, NCCL on two or more) at kitti_sem's full width, each against
     its single-device counterpart on the same card: the dp=2 f32 step
     (K4, K6 in each rank), the dp=2 bf16 affine step (K3, K5, K6 once a
     step), `make_spatial_infer` at sp=2 (f32 parity; at the serving
     settings K1, K3, K2 once a scan), the sp=2 f32 spmd step, and
     fine_grid through 'affine' at sp=2 (K10, K3, K2 once a scan); every
     rank's launches go into `launches_by_path` as parallel_<run>_rank<r>;
 29. the kernels line, the card line, then the result line.
Any failed check raises, so the exit code is non-zero and no result line
is printed.  Without a CUDA device the script exits with code 2.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from gndnet_tpu_torch import _ext, evaluate, native, profile_affine, train
from gndnet_tpu_torch.config import (camera_config, custom_local_config,
                                     fine_grid_config, kitti_sem_config,
                                     sparse_32beam_config)
from gndnet_tpu_torch.data import generator
from gndnet_tpu_torch.data.provider import StreamingLoader, prefetch_to_device
from gndnet_tpu_torch.infer import GroundInferenceEngine, StreamingEngine
from gndnet_tpu_torch.models.gndnet import GroundEstimatorNet
from gndnet_tpu_torch.ops import affine, affine_aux, segment, sort
from gndnet_tpu_torch.ops import pillarize as pz
from gndnet_tpu_torch.ops.postproc import _cell_indices, lidar_to_heightmap
from gndnet_tpu_torch.parallel import multihost
from gndnet_tpu_torch.profile_affine import serving_config, time_ms
from gndnet_tpu_torch.profile_serve import card, kernel_times
from gndnet_tpu_torch.serving.replay import replay, replay_device
from gndnet_tpu_torch.synthetic import (synthetic_labelled_batch,
                                        synthetic_scan,
                                        synthetic_semantic_kitti_scan,
                                        write_semantic_kitti_sequence)
from gndnet_tpu_torch.weights import init_state_dict

REPO = os.path.dirname(os.path.abspath(__file__))

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
    when a window recorded fewer device operations than calls (every fn
    profiled here launches at least one kernel a call; torch.profiler now
    and then drops some or all of a window's device records in a long
    process)."""
    fn()
    for _ in range(3):
        prof = kernel_times(fn, 20)
        ops = prof.get("device_ops_per_call")
        if isinstance(ops, float) and ops >= 1.0:
            return ops, prof["device_ms_per_call"]
    require(False, "the profiler recorded fewer kernels than calls in 3 "
                   "windows")


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
KW = dict(zip(("K1", "K3", "K2", "K4", "K5", "K6", "K7", "K8", "K9", "K10"),
              COUNTERS))
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


# the device kernels of K1-K10 as torch.profiler names them (demangled)
KERNEL_NAMES = {
    "K1": r"radix_kernel<[^>]*I32>|tile_kernel\(int\*|global_stage\(int\*",
    "K2": r"scan_cells<\w+, \d+, 0>",
    "K3": r"hist_cluster|hist_global|ends_global",
    "K4": r"scan_cells<\w+, \d+, 2>",
    "K5": r"scan_cells<\w+, \d+, 1>",
    "K6": r"\bdmmat\b",
    "K7": r"suffix_scan",
    "K8": r"k8_scan",
    "K9": r"k9_broadcast",
    "K10": r"radix_kernel<[^>]*Pair>|tile_kernel\(int const\*"
           r"|global_stage\(long long\*",
}
AOT_SCANS = 20
PIPELINE_SCANS = 32
STREAM_SCANS = 16
STREAM_TIMEOUT_S = 60.0


def device_kernels(fn, reps: int = 20) -> dict:
    """Device operations one call of fn() runs, by name, per call
    (torch.profiler over `reps` warm calls; again, up to 3 windows, when
    a window recorded no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        names = {evt.key: evt.count / reps for evt in prof.key_averages()
                 if evt.device_type.name == "CUDA"
                 and (getattr(evt, "self_device_time_total", 0) or 0) > 0}
        if names:
            return names
    require(False, "the profiler saw no kernel in 3 windows")


def k_counts(names: dict) -> dict:
    """Launches a call of each of K1-K10, rounded: the profiler drops a
    device record now and then (232.6 of a replay's 233 operations a call
    over 5 calls, seen on an H100 80GB HBM3 at 700 W)."""
    return {k: round(sum(c for name, c in names.items()
                         if re.search(pat, name)))
            for k, pat in KERNEL_NAMES.items()}


def host_seconds(fn, items) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for item in items:
        fn(item)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def graph_case(name, cfg, sd, scans, other, n_points, device, want,
               tmp) -> tuple:
    """aot_save, aot_load into a fresh engine (one CUDA graph of `run`),
    the graph against the eager engine's `run` on the same padded input,
    the kernels of a replay, an eagerly served scan of another bucket, and
    the host-clock and device times of both engines.  Returns (result,
    graph engine, launches of the eager bucket)."""
    path = f"{tmp}/{name}.aot"
    eager = GroundInferenceEngine(cfg, sd, device=device)
    size = eager.aot_save(path, n=n_points)
    eager.warmup()
    served = GroundInferenceEngine(cfg, sd, device=device)
    t0 = time.perf_counter()
    served.aot_load(path)
    capture_s = time.perf_counter() - t0
    shape, graph = served._graph
    require(graph is not None, f"{name}: aot_load captured no graph")
    padded = [torch.from_numpy(eager._prepare(s)[0]).to(device)
              for s in scans]
    require(all(tuple(p.shape) == shape for p in padded),
            f"{name}: scans outside the recorded bucket {shape}")
    reset_launches()
    worst_elev, mismatch = 0.0, 0
    for p in padded:
        e_eager, l_eager = eager.run(p)
        replays = graph.replays
        e_graph, l_graph = served._dispatch(p)
        require(graph.replays == replays + 1, f"{name}: not replayed")
        if name == "scatter":
            worst_elev = max(worst_elev,
                             float((e_graph - e_eager).abs().max()))
            diff = (l_graph != l_eager).nonzero()[:, 0]
            mismatch += int(diff.numel())
            if diff.numel():
                pts = eager.device_points(p)[diff]
                ix, iy = _cell_indices(pts, cfg.grid_range,
                                       cfg.voxel_size[0])
                margin = (pts[:, 2] - eager.threshold - e_eager.t()[
                    ix.clamp(0, cfg.nx - 1).long(),
                    iy.clamp(0, cfg.ny - 1).long()]).abs()
                require(bool((margin <= IMPL_ELEV_ATOL).all()),
                        "scatter: graph labels differ away from the "
                        "threshold")
        else:
            require(torch.equal(e_graph, e_eager)
                    and torch.equal(l_graph, l_eager),
                    f"{name}: graph replay differs from eager run")
    torch.cuda.synchronize()
    eager_counts = {fn.__name__: fn.launches for fn in COUNTERS}
    reset_launches()
    for p in padded:
        served._dispatch(p)
    read_launches((), f"serve_aot_{name}_graph")
    if name == "scatter":
        require(worst_elev <= IMPL_ELEV_ATOL,
                f"scatter: graph vs eager elevation {worst_elev}")
    names = device_kernels(lambda: served._dispatch(padded[0]))
    ks = k_counts(names)
    for k, count in ks.items():
        require(count == want.get(k, 0),
                f"{name}: {k} ran {count} times a replay, not "
                f"{want.get(k, 0)}")
    reset_launches()
    e_other, l_other = served.infer(other)
    launched = read_launches(tuple(KW[k] for k in want),
                             f"serve_aot_{name}_other_bucket")
    for k, count in want.items():
        require(KW[k].launches == count,
                f"{name}: another bucket launched {k} {KW[k].launches} "
                f"times, not {count}")
    require(np.isfinite(e_other).all() and l_other.shape == (len(other),),
            f"{name}: another bucket's result")
    # host clock, both engines warm (their pinned slots allocated):
    # eager, graph, graph, eager over the same scans
    for engine in (eager, served):
        host_seconds(engine.infer, scans[:4])
    secs = [host_seconds(engine.infer, scans)
            for engine in (eager, served, served, eager)]
    it = iter(scans * 2)
    prof_eager = kernel_times(lambda: eager.infer(next(it)), 10)
    it = iter(scans * 2)
    prof_graph = kernel_times(lambda: served.infer(next(it)), 10)
    return {
        "fused_impl": cfg.fused_impl, "compute_dtype": cfg.compute_dtype,
        "artifact_bytes": size, "padded_shape": list(shape),
        "capture_s": capture_s, "scans": len(scans),
        "bit_equal": name != "scatter",
        "elevation_vs_eager": worst_elev, "label_mismatch": mismatch,
        "eager_run_launches": eager_counts,
        "replay_kernels": ks, "replay_device_ops": sum(names.values()),
        "scans_per_s": {"eager": [len(scans) / secs[0], len(scans) / secs[3]],
                        "graph": [len(scans) / secs[1], len(scans) / secs[2]]},
        "infer_ms": {"eager": [1e3 * secs[0] / len(scans),
                               1e3 * secs[3] / len(scans)],
                     "graph": [1e3 * secs[1] / len(scans),
                               1e3 * secs[2] / len(scans)]},
        "device_ms_per_scan": {
            "eager": prof_eager.get("device_ms_per_call"),
            "graph": prof_graph.get("device_ms_per_call")},
        "busy_share": {"eager": prof_eager.get("device_busy_share"),
                       "graph": prof_graph.get("device_busy_share")},
        "device_ops_per_scan": {
            "eager": prof_eager.get("device_ops_per_call"),
            "graph": prof_graph.get("device_ops_per_call")},
    }, served, launched


def serve_aot(cfg, sd, rng, n_points, device) -> dict:
    """Phase 19: the warm start for 'affine', 'sorted' and 'scatter'."""
    scans = [synthetic_scan(cfg, rng, n_points) for _ in range(AOT_SCANS)]
    other = synthetic_scan(cfg, rng, n_points + 2 * 4096)
    shipped = SHIPPED["kitti_sem"]()
    cases = (("affine", cfg, sd, {"K1": 1, "K3": 1, "K2": 1}),
             ("sorted", cfg.replace(fused_impl="sorted"), sd, {"K7": 3}),
             ("scatter", shipped, init_state_dict(shipped, seed=SEED), {}))
    out = {"phase": "serve_aot", "elevation_atol_scatter": IMPL_ELEV_ATOL}
    paths, engines = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, c, weights, want in cases:
            out[name], engines[name], launched = graph_case(
                name, c, weights, scans, other, n_points, device, want, tmp)
            paths[f"serve_aot_{name}_other_bucket"] = launched
    return {"launches": paths, "result": out, "engine": engines["affine"],
            "scans": scans}


def pipelined(engine, scans, rng, n_points) -> dict:
    """Phase 20: infer_pipelined(depth=3) on the graph engine."""
    scans = scans + [synthetic_scan(engine.cfg, rng, n_points)
                     for _ in range(PIPELINE_SCANS - len(scans))]
    want = [engine.infer(s) for s in scans]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = list(engine.infer_pipelined(scans, depth=3))
    piped = time.perf_counter() - t0
    require(len(got) == len(scans)
            and all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                    for a, b in zip(got, want)),
            "infer_pipelined differs from infer")
    sequential = host_seconds(engine.infer, scans)
    return {"phase": "pipelined", "scans": len(scans), "depth": 3,
            "bit_equal_to_infer": True,
            "scans_per_s": len(scans) / piped,
            "sequential_scans_per_s": len(scans) / sequential}


def streaming(engine, rng, n_points) -> dict:
    """Phase 21: StreamingEngine with the native mailbox, replay_device
    and replay on the graph engine."""
    require(native.available(), "the native host library did not build")
    scans = [synthetic_scan(engine.cfg, rng, n_points)
             for _ in range(STREAM_SCANS)]
    srv = StreamingEngine(engine, warmup=True,
                          use_native_mailbox=True).start()
    try:
        require(srv.native_mailbox, "StreamingEngine took the lock path")
        for scan in scans:
            seq = srv.submit(scan)
            deadline = time.perf_counter() + STREAM_TIMEOUT_S
            while (srv.latest() is None or srv.latest()[0] < seq) \
                    and srv.errors == 0 and time.perf_counter() < deadline:
                time.sleep(0.0002)
            require(srv.errors == 0, f"streaming errors: {srv.last_error}")
            require(srv.latest()[0] == seq, f"no result for scan {seq}")
        _, elev, labels = srv.latest()
        e1, l1 = engine.infer(scans[-1])
        require(np.array_equal(elev, e1) and np.array_equal(labels, l1),
                "the last streamed result is not infer of the last scan")
        processed = srv.processed
    finally:
        srv.stop()
    free = replay_device(engine, scans[0], target_hz=0.0)
    require(free.drop_fraction == 0.0
            and free.scans_processed == free.scans_submitted,
            f"free-wheeling replay_device dropped {free.drop_fraction}")
    paced = replay_device(engine, scans[0])
    fed = replay(engine, scans)
    require(fed.scans_processed == fed.scans_submitted == len(scans),
            "replay lost scans")
    return {"phase": "streaming", "native_mailbox": True,
            "fed_forward": {"scans": len(scans), "processed": processed,
                            "errors": 0, "last_equals_infer": True},
            "replay_device_free": free.as_dict(),
            "replay_device_55hz": paced.as_dict(),
            "replay": fed.as_dict()}


EVAL_FRAMES = 4          # frames of the generated SemanticKITTI sequence
SCAN_POINTS = 100_000    # points of each raw scan
AUG_STEPS = 5            # augmented sparse_32beam steps
EVAL_IOU_ATOL = 1e-4     # IoU, kernel path vs plain path at float32
EVAL_ELEV_ATOL = 1e-4    # f32 elevation kernel vs plain, as `parity`
GEN_GRID_ATOL = 1e-6     # generated grid on the card vs the CPU


def with_workers(cfg, n: int):
    return cfg.replace(data_prep=dataclasses.replace(cfg.data_prep,
                                                     num_workers=n))


def generate(cfg, rng, root: str, device) -> dict:
    """Phase 22: a SemanticKITTI-layout sequence of EVAL_FRAMES synthetic
    scans (ground 40/48/72, obstacles 10/50, some 0/1 unlabeled) through
    `generate_dataset` on the card with one worker; every frame written,
    finite, and the first frame's grid equal to a CPU run's."""
    raw = os.path.join(root, "raw")
    seq = os.path.join(raw, "sequences", "00")
    write_semantic_kitti_sequence(seq, [
        synthetic_semantic_kitti_scan(cfg, rng, SCAN_POINTS)
        for _ in range(EVAL_FRAMES)])
    out = os.path.join(root, "gen")
    one = with_workers(cfg, 1)
    t0 = time.perf_counter()
    n = generator.generate_dataset(raw, out, one, seed=SEED, device=device)
    seconds = time.perf_counter() - t0
    require(n == EVAL_FRAMES, f"generate_dataset wrote {n} frames")
    frames = os.path.join(out, "sequences", "00")
    for i in range(n):
        velo = np.load(os.path.join(frames, "reduced_velo", f"{i:06d}.npy"))
        grid = np.load(os.path.join(frames, "gnd_labels", f"{i:06d}.npy"))
        require(velo.shape == (cfg.num_points, 4)
                and np.isfinite(velo).all(), f"generated cloud {i}")
        require(grid.shape == (cfg.ny, cfg.nx) and np.isfinite(grid).all(),
                f"generated grid {i}")
    cpu = os.path.join(root, "gen_cpu")
    t0 = time.perf_counter()
    generator.generate_sequence(seq, cpu, one, count=1, index_base=0,
                                seed=SEED, device="cpu")
    cpu_s = time.perf_counter() - t0
    grid = np.load(os.path.join(frames, "gnd_labels", "000000.npy"))
    grid_cpu = np.load(os.path.join(cpu, "gnd_labels", "000000.npy"))
    d_grid = float(np.abs(grid - grid_cpu).max())
    require(d_grid <= GEN_GRID_ATOL, f"generated grid card vs CPU {d_grid}")
    velo = np.load(os.path.join(frames, "reduced_velo", "000000.npy"))
    velo_cpu = np.load(os.path.join(cpu, "reduced_velo", "000000.npy"))
    # one warm frame on the card and on the CPU, in turns; the card's
    # share: the rasterisation of frame 0's ground points, by CUDA events
    warm = {"card": [], "cpu": []}
    for i, (name, dev) in enumerate((("card", device), ("cpu", "cpu"),
                                     ("card", device), ("cpu", "cpu"))):
        t0 = time.perf_counter()
        generator.generate_sequence(seq, os.path.join(root, f"warm{i}"), one,
                                    count=1, index_base=0, seed=SEED,
                                    device=dev)
        warm[name].append(time.perf_counter() - t0)
    gnd, _ = generator.split_ground(generator.load_scan(
        os.path.join(seq, "velodyne", "000000.bin"),
        os.path.join(seq, "labels", "000000.label")))
    gnd = torch.as_tensor(gnd[:, :3], device=device)
    raster_ms = time_ms(lambda: lidar_to_heightmap(
        gnd, cfg.grid_range, cfg.voxel_size[0], 100, cfg.lidar_height))
    return {"raw": raw, "sequence": seq, "out": out, "result": {
        "phase": "generate", "frames": n, "points_per_scan": SCAN_POINTS,
        "num_points": cfg.num_points, "grid": [cfg.ny, cfg.nx],
        "seconds": seconds, "seconds_per_frame": seconds / n,
        "cpu_seconds_per_frame": cpu_s,
        "warm_seconds_per_frame": warm,
        "rasterise_ms": raster_ms, "ground_points": int(gnd.shape[0]),
        "grid_max_abs_diff_vs_cpu": d_grid,
        "grid_atol": GEN_GRID_ATOL,
        "cloud_rows_differing_vs_cpu": int(
            (velo != velo_cpu).any(axis=1).sum())}}


def f32_eval_parity(cfg, sd, frames, device) -> dict:
    """The kernel path against the plain path at float32 / 'highest' on
    the evaluation frames: per-frame metrics from each path's outputs, IoU
    within EVAL_IOU_ATOL, and every differing label within EVAL_ELEV_ATOL
    of the threshold, as `parity` requires."""
    cfg32 = cfg.replace(compute_dtype="float32", matmul_precision="highest")
    engine = GroundInferenceEngine(cfg32, sd, threshold=0.0,
                                   shift_cloud=True, device=device)
    kern, plain, worst = [], [], {"iou": 0.0, "elevation": 0.0, "labels": 0}
    for cloud, sem in frames:
        padded, n = engine._prepare(cloud)
        padded = torch.from_numpy(padded)
        ek, lk = engine.run(padded)
        ep, lp = engine.run(padded, reference=True)
        d_elev = float((ek - ep).abs().max())
        require(d_elev <= EVAL_ELEV_ATOL, f"f32 eval elevation {d_elev}")
        gt = evaluate.ground_truth_seg(sem)
        for out, (e, lab) in ((kern, (ek, lk)), (plain, (ep, lp))):
            out.append(evaluate.seg_metrics(lab[:n].cpu().numpy(), gt) + (
                evaluate.height_mse(cfg32, e.cpu().numpy(), cloud, sem,
                                    True, device),))
        d_iou = abs(kern[-1][0] - plain[-1][0])
        require(d_iou <= EVAL_IOU_ATOL,
                f"f32 eval IoU kernel vs plain {d_iou}")
        diff = (lk[:n] != lp[:n]).nonzero()[:, 0]
        if diff.numel():
            pts = engine.device_points(padded)
            ix, iy = _cell_indices(pts[diff], cfg.grid_range,
                                   cfg.voxel_size[0])
            ix = ix.clamp(0, cfg.nx - 1).long()
            iy = iy.clamp(0, cfg.ny - 1).long()
            margin = (pts[diff, 2] - ep.t()[ix, iy]
                      - engine.threshold).abs()
            require(bool((margin <= EVAL_ELEV_ATOL).all()),
                    "evaluation labels differ away from the threshold")
        worst["iou"] = max(worst["iou"], d_iou)
        worst["elevation"] = max(worst["elevation"], d_elev)
        worst["labels"] += int(diff.numel())
    api = evaluate.evaluate_frames(cfg32, sd, frames, 0.0, True,
                                   device=device)
    d_api = float(np.abs(np.array(api.per_frame)[:, 0]
                         - np.array(kern)[:, 0]).max())
    require(d_api <= EVAL_IOU_ATOL, f"f32 evaluate_frames vs run {d_api}")
    return {"iou_atol": EVAL_IOU_ATOL, "elevation_atol": EVAL_ELEV_ATOL,
            "max_abs_diff": worst, "kernel_per_frame": kern,
            "plain_per_frame": plain}


def evaluate_phase(cfg, sd, seq: str, gen_out: str, device) -> dict:
    """Phase 23: `evaluate_semantic_kitti` at the serving settings (K1, K3
    and K2 once a frame), its time split between the engine and the host
    metrics, the float32 kernel path against the plain path,
    `evaluate_height_rmse` on the generated frames (K3 and K2 once a
    batch), and the evaluation CLI as shipped."""
    frames = list(evaluate.semantic_kitti_frames(seq))
    reset_launches()
    t0 = time.perf_counter()
    res = evaluate.evaluate_semantic_kitti(cfg, sd, seq, threshold=0.0,
                                           device=device)
    api_s = time.perf_counter() - t0
    launches = {"evaluate": read_launches((K1, K3, K2), "evaluate")}
    for fn in (K1, K3, K2):
        require(fn.launches == len(frames),
                f"{fn.__name__} launched {fn.launches} times for "
                f"{len(frames)} evaluated frames, not once a frame")
    require(res.frames == len(frames) and 0 <= res.iou <= 1
            and np.isfinite(res.mse), f"evaluation result {res.as_dict()}")

    # the loop of evaluate_frames on a warm engine, timed by part
    engine = GroundInferenceEngine(cfg, sd, threshold=0.0, shift_cloud=True,
                                   device=device)
    engine.warmup()
    engine_s = metrics_s = 0.0
    per = []
    for cloud, sem in frames:
        t0 = time.perf_counter()
        pred, seg = engine.infer(cloud)
        t1 = time.perf_counter()
        per.append(evaluate.seg_metrics(seg, evaluate.ground_truth_seg(sem))
                   + (evaluate.height_mse(cfg, pred, cloud, sem, True,
                                          device),))
        metrics_s += time.perf_counter() - t1
        engine_s += t1 - t0
    d_rep = float(np.abs(np.array(per) - np.array(res.per_frame)).max())
    require(d_rep <= EVAL_IOU_ATOL, f"timed loop vs evaluate {d_rep}")

    parity32 = f32_eval_parity(cfg, sd, frames, device)

    reset_launches()
    t0 = time.perf_counter()
    rmse = evaluate.evaluate_height_rmse(cfg, sd, gen_out, split="sequences",
                                         device=device)
    rmse_s = time.perf_counter() - t0
    launches["evaluate_height_rmse"] = read_launches((K3, K2),
                                                     "evaluate_height_rmse")
    batches = -(-EVAL_FRAMES // cfg.batch_size)
    for fn in (K3, K2):
        require(fn.launches == batches,
                f"{fn.__name__} launched {fn.launches} times for {batches} "
                "evaluate_height_rmse batches, not once a batch")
    require(rmse["frames"] == EVAL_FRAMES
            and np.isfinite(rmse["per_frame"]).all(), f"rmse {rmse}")

    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "gndnet_tpu_torch.scripts.evaluate",
         "--config", "kitti_sem", "--data_dir", seq], cwd=REPO,
        capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    require(cli.returncode == 0, f"evaluate CLI exit {cli.returncode}: "
                                 f"{cli.stderr[-2000:]}")
    printed = ast.literal_eval(cli.stdout.strip().splitlines()[-1])
    require(printed["frames"] == len(frames) and np.isfinite(printed["mse"]),
            f"evaluate CLI printed {printed}")
    n = len(frames)
    return {"launches": launches, "result": {
        "phase": "evaluate", "fused_impl": cfg.fused_impl,
        "compute_dtype": cfg.compute_dtype, "frames": n,
        "points_per_scan": int(frames[0][0].shape[0]), "threshold": 0.0,
        "metrics": res.as_dict(), "seconds": api_s,
        "ms_per_frame": api_s / n * 1e3,
        "warm_ms_per_frame": (engine_s + metrics_s) / n * 1e3,
        "warm_engine_ms_per_frame": engine_s / n * 1e3,
        "warm_metrics_ms_per_frame": metrics_s / n * 1e3,
        "engine_share": engine_s / (engine_s + metrics_s),
        "launches": launches["evaluate"], "f32_parity": parity32,
        "height_rmse": {"frames": rmse["frames"], "rmse": rmse["rmse"],
                        "batches": batches, "seconds": rmse_s,
                        "launches": launches["evaluate_height_rmse"]},
        "cli": {"config": "kitti_sem", "exit": cli.returncode,
                "seconds": cli_s, "printed": printed}}}


def timed_steps(step, state, batches) -> tuple:
    """(state, losses, ms a step) of `step` over device `batches`."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for pts, labels in batches:
        state, loss = step(state, pts, labels)
        losses.append(loss)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / len(batches) * 1e3
    return state, [float(v) for v in losses], ms


def train_augmented(raw: str, root: str, device) -> dict:
    """Phase 24: sparse_32beam (50 000 points, the kitti_sem grid) at B=2,
    bf16 'affine', augment=True: its frames generated from the raw
    sequence, AUG_STEPS steps fed by StreamingLoader and
    prefetch_to_device, K3, K5 and K6 once a step; then the augmented and
    the unaugmented step on the same device batches, ms a step each."""
    cfg = serving_config(sparse_32beam_config())
    out = os.path.join(root, "gen_sparse")
    t0 = time.perf_counter()
    n = generator.generate_dataset(raw, out, with_workers(cfg, 1), seed=SEED,
                                   device=device)
    gen_s = time.perf_counter() - t0
    require(n == EVAL_FRAMES, f"sparse_32beam frames written: {n}")
    loader = StreamingLoader(out, "sequences", TRAIN_BATCH,
                             num_input_features=cfg.input_features,
                             seed=SEED)

    def stream(steps):
        epoch, k = 0, 0
        while True:
            for item in loader.epoch(epoch):
                yield item
                k += 1
                if k == steps:
                    return
            epoch += 1

    sd = init_state_dict(cfg, seed=SEED)
    state = train.create_train_state(cfg, len(loader), state_dict=sd,
                                     device=device)
    step = train.make_train_step(cfg, augment=True)
    feed = prefetch_to_device(stream(AUG_STEPS + 1), device)
    warm = next(feed)
    state, loss = step(state, *warm)                     # cuDNN plans
    require(bool(torch.isfinite(loss)), "first augmented loss finite")
    reset_launches()
    t0 = time.perf_counter()
    staged, losses = [], []
    for pts, labels in feed:
        state, loss = step(state, pts, labels)
        staged.append((pts, labels))
        losses.append(loss)
    torch.cuda.synchronize()
    stream_ms = (time.perf_counter() - t0) / len(staged) * 1e3
    launches = read_launches((K3, K5, K6), "train_augmented")
    require(len(staged) == AUG_STEPS, f"{len(staged)} streamed batches")
    for fn in (K3, K5, K6):
        require(fn.launches == AUG_STEPS,
                f"{fn.__name__} launched {fn.launches} times in {AUG_STEPS} "
                "augmented steps, not once a step")
    losses = [float(v) for v in losses]
    require(all(np.isfinite(losses)), f"augmented losses finite: {losses}")

    state, aug_losses, aug_ms = timed_steps(step, state, staged)
    plain = train.create_train_state(cfg, len(loader), state_dict=sd,
                                     device=device)
    plain_step = train.make_train_step(cfg)
    plain, _ = plain_step(plain, *warm)
    plain, plain_losses, plain_ms = timed_steps(plain_step, plain, staged)
    require(all(np.isfinite(aug_losses + plain_losses)),
            "staged losses finite")
    aug_ops, aug_dev_ms = device_profile(lambda: step(state, *warm))
    plain_ops, plain_dev_ms = device_profile(lambda: plain_step(plain,
                                                                *warm))
    return {"launches": launches, "result": {
        "phase": "train_augmented", "config": "sparse_32beam",
        "fused_impl": cfg.fused_impl, "compute_dtype": cfg.compute_dtype,
        "batch": TRAIN_BATCH, "points_per_scan": cfg.num_points,
        "generate_seconds": gen_s, "steps": AUG_STEPS, "losses": losses,
        "launches": launches, "streamed_ms_per_step": stream_ms,
        "staged_augmented_ms_per_step": aug_ms,
        "staged_unaugmented_ms_per_step": plain_ms,
        "device_ms_per_step": {"augmented": aug_dev_ms,
                               "unaugmented": plain_dev_ms},
        "device_ops_per_step": {"augmented": aug_ops,
                                "unaugmented": plain_ops},
        "staged_losses": {"augmented": aug_losses,
                          "unaugmented": plain_losses}}}


PILLAR_STEP_RTOL = 1e-3     # the use_norm invariant (tests/test_train.py)
# its loss: the two steps take the PFN's batch statistics over 2e5 flat
# rows and over 2e6 pillar rows, var = E[z^2] - E[z]^2 in float32 either
# way; this phase measured up to 1.80e-5 at kitti_sem's width on an H100
# 80GB HBM3 at 700 W (tests/test_train.py's 1e-5 is for a 16x16 grid)
PILLAR_LOSS_RTOL = 1e-4
INVARIANT_BATCHES = 4
PILLAR_CANVAS_SHARE = 1e-5  # pillar canvas vs fused 'scatter', of scale


def share_of_scale(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-12)


def peak_memory_gb(fn) -> tuple:
    """(fn's result, ms by the host clock, peak device memory in GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, (time.perf_counter() - t0) * 1e3,
            torch.cuda.max_memory_allocated() / 2**30)


def earliest_pillars_kept(scan: np.ndarray, cfg, pb) -> dict:
    """fine_grid's `pillarize`: more occupied cells than `max_voxels`, so
    exactly `max_voxels` pillars, which must be the cells first touched
    earliest in the scan, in that order (numpy on the host)."""
    lo = np.asarray(cfg.pc_range[:3], np.float32)
    vs = np.asarray(cfg.voxel_size, np.float32)
    c = np.floor((scan[:, :3] - lo) / vs).astype(np.int64)    # float32
    grid = np.asarray(cfg.grid_size)
    ok = ((c >= 0) & (c < grid)).all(axis=1)
    cell = (c[ok, 2] * cfg.ny + c[ok, 1]) * cfg.nx + c[ok, 0]
    uniq, first = np.unique(cell, return_index=True)
    want = uniq[np.argsort(first)][:cfg.max_voxels]
    coors = pb.coors.cpu().numpy().astype(np.int64)
    got = (coors[:, 0] * cfg.ny + coors[:, 1]) * cfg.nx + coors[:, 2]
    require(len(uniq) > cfg.max_voxels, f"fine_grid scan occupies "
            f"{len(uniq)} cells, not more than {cfg.max_voxels}")
    require(int(pb.n_pillars) == cfg.max_voxels and bool(pb.mask.all()),
            f"fine_grid n_pillars {int(pb.n_pillars)}")
    require(np.array_equal(got, want), "fine_grid pillars are not the "
                                       "earliest-touched cells in order")
    return {"occupied_cells": int(len(uniq)), "max_voxels": cfg.max_voxels,
            "n_pillars": int(pb.n_pillars)}


def pillar_step(cfg, sd, points, labels, device, use_pillar_path=True):
    state = train.create_train_state(cfg, 100, state_dict=sd, device=device)
    before = params_of(state)
    step = train.make_train_step(cfg, use_pillar_path=use_pillar_path)
    (state, loss), ms, peak = peak_memory_gb(
        lambda: step(state, points, labels))
    loss = float(loss)
    require(np.isfinite(loss), f"pillar-path loss {loss}")
    return state, loss, before, ms, peak


def use_norm_invariant(cfg, pts, lab, rng, n_points: int, device) -> dict:
    """The fused use_norm step against the pillar-path step from the same
    weights (tests/test_train.py:196-215) on INVARIANT_BATCHES batches,
    the first `pts`: loss within PILLAR_LOSS_RTOL, parameters within
    PILLAR_STEP_RTOL / atol 1e-5."""
    c = cfg.replace(use_norm=True)
    csd = init_state_dict(c, seed=SEED)
    rels, worst = [], 0.0
    for k in range(INVARIANT_BATCHES):
        if k:
            batch = synthetic_labelled_batch(c, rng, TRAIN_BATCH, n_points)
            pts, lab = (torch.as_tensor(x, device=device) for x in batch)
        pillar, loss, _, _, _ = pillar_step(c, csd, pts, lab, device)
        fused, fused_loss, _, _, _ = pillar_step(c, csd, pts, lab, device,
                                                 use_pillar_path=False)
        rels.append(abs(fused_loss - loss) / abs(loss))
        a, b = params_of(pillar), params_of(fused)
        bad = [n for n in a if not torch.allclose(
            b[n], a[n], rtol=PILLAR_STEP_RTOL, atol=1e-5)]
        require(not bad, f"use_norm fused vs pillar step: {bad}")
        worst = max(worst, max(float((b[n] - a[n]).abs().max()) for n in a))
    require(max(rels) <= PILLAR_LOSS_RTOL,
            f"use_norm fused vs pillar step losses {rels}")
    return {"loss_rel_diff": rels, "loss_rtol": PILLAR_LOSS_RTOL,
            "param_rtol": PILLAR_STEP_RTOL, "param_max_abs_diff": worst}


def pillar_path(rng, n_points: int, device) -> dict:
    """Phase 25: the reference-style pillar path at kitti_sem as shipped
    (float32, 'highest', TF32 off), B=2 scans of n_points:
    `pillarize_batch` + `forward` against the fused 'scatter' path (canvas
    within PILLAR_CANVAS_SHARE of scale, elevation within IMPL_ELEV_ATOL),
    no kernel of K1-K10 launched; one pillar-path train step with use_norm
    off and on, and the use_norm invariant (the fused step against the
    pillar step); a two-layer PFN (vfe_filters (32, 64)) forward and step,
    finite, every parameter moved; fine_grid's `pillarize` over capacity.
    ms a forward and a step by the host clock, peak device memory."""
    cfg = SHIPPED["kitti_sem"]()
    sd = init_state_dict(cfg, seed=SEED)
    set_bn_stats(sd, rng)
    points, labels = synthetic_labelled_batch(cfg, rng, TRAIN_BATCH,
                                              n_points)
    pts = torch.as_tensor(points, device=device)
    model = GroundEstimatorNet(cfg, device=device)
    model.load_state_dict(sd)
    out = {"phase": "pillar_path", "card": card(), "batch": TRAIN_BATCH,
           "points_per_scan": n_points, "max_voxels": cfg.max_voxels,
           "elevation_atol": IMPL_ELEV_ATOL,
           "canvas_share": PILLAR_CANVAS_SHARE}

    def forward():
        pb = pz.pillarize_batch(pts, model.geom, cfg.max_points_voxel,
                                cfg.max_voxels)
        return pb, model(pb.voxels, pb.coors, pb.num_points, pb.mask)

    forward()                                          # warm: cuDNN plans
    reset_launches()
    (pb, elev), fwd_ms, fwd_peak = peak_memory_gb(forward)
    read_launches((), "pillar_path")
    with torch.no_grad():
        canvas = model.pillar_canvas(pb.voxels, pb.coors, pb.num_points,
                                     pb.mask)
        fused_canvas = model.canvas(pts)
        fused = model.fused(pts)
    d_canvas = share_of_scale(canvas, fused_canvas)
    d_elev = float((elev - fused).abs().max())
    require(d_canvas <= PILLAR_CANVAS_SHARE,
            f"pillar canvas vs fused: {d_canvas} of scale")
    require(d_elev <= IMPL_ELEV_ATOL, f"pillar elevation vs fused {d_elev}")
    out["forward"] = {"ms": fwd_ms, "peak_mem_gb": fwd_peak,
                      "n_pillars": [int(n) for n in pb.n_pillars],
                      "canvas_diff_of_scale": d_canvas,
                      "elevation_max_abs_diff": d_elev}

    lab = torch.as_tensor(labels, device=device)
    steps = {}
    for use_norm in (False, True):
        c = cfg.replace(use_norm=use_norm)
        csd = init_state_dict(c, seed=SEED)
        pillar_step(c, csd, pts, lab, device)             # warm
        reset_launches()
        state, loss, before, ms, peak = pillar_step(c, csd, pts, lab,
                                                    device)
        read_launches((), "pillar_path_train")
        moved = [k for k, v in params_of(state).items()
                 if not torch.equal(v, before[k])]
        require(len(moved) == len(before), "pillar step: parameters that "
                f"did not move: {sorted(set(before) - set(moved))}")
        steps[f"use_norm_{use_norm}"] = {"loss": loss, "ms": ms,
                                         "peak_mem_gb": peak}
    steps["use_norm_invariant"] = use_norm_invariant(cfg, pts, lab, rng,
                                                     n_points, device)
    out["train"] = steps

    deep = cfg.replace(vfe_filters=(32, 64), use_norm=True)
    dsd = init_state_dict(deep, seed=SEED)
    dmodel = GroundEstimatorNet(deep, device=device)
    dmodel.load_state_dict(dsd)
    delev = dmodel(pb.voxels, pb.coors, pb.num_points, pb.mask)
    require(bool(torch.isfinite(delev).all()), "two-layer PFN elevation")
    _, dloss, _, dms, dpeak = pillar_step(deep, dsd, pts, lab, device)
    state, dloss, before, dms, dpeak = pillar_step(deep, dsd, pts, lab,
                                                   device)
    still = [k for k, v in params_of(state).items()
             if torch.equal(v, before[k])]
    require(not still, f"two-layer PFN step: parameters unmoved {still}")
    out["vfe_32_64"] = {"loss": dloss, "ms": dms, "peak_mem_gb": dpeak,
                        "params": len(before)}

    fine = SHIPPED["fine_grid"]()
    scan = synthetic_scan(fine, rng, n_points)
    fpb = pz.pillarize(torch.as_tensor(scan, device=device),
                       pz.PillarGeometry.from_config(fine),
                       fine.max_points_voxel, fine.max_voxels)
    out["fine_grid_pillarize"] = earliest_pillars_kept(scan, fine, fpb)
    return out


def loss_scaling(cfg, sd, rng) -> dict:
    """Phase 26: kitti_sem B=2 bf16 'affine' training with loss scaling:
    one scaled step (K3, K5 and K6 once) against the unscaled step from the
    same weights and batch (largest parameter difference printed), then a
    forced overflow (scale at the float32 maximum, alpha 1000 and labels
    10 off) that must change nothing but the scale, halved, and the step
    count."""
    points, labels = synthetic_labelled_batch(cfg, rng, TRAIN_BATCH,
                                              cfg.num_points)
    step = train.make_train_step(cfg)
    warm = train.create_train_state(cfg, 100, state_dict=sd,
                                    loss_scaling=True)
    step(warm, points, labels)                         # warm: cuDNN plans
    plain = train.create_train_state(cfg, 100, state_dict=sd)
    scaled = train.create_train_state(cfg, 100, state_dict=sd,
                                      loss_scaling=True)
    _, plain_loss = step(plain, points, labels)
    reset_launches()
    t0 = time.perf_counter()
    _, loss = step(scaled, points, labels)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches((K3, K5, K6), "loss_scaling")
    for fn in (K3, K5, K6):
        require(fn.launches == 1, f"{fn.__name__} launched {fn.launches} "
                                  "times in one loss-scaled step")
    ds = scaled.dynamic_scale
    require(np.isfinite(float(loss)) and ds.fin_steps == 1
            and ds.scale == 65536.0, f"scaled step: loss {float(loss)}, "
            f"scale {ds.scale}, fin_steps {ds.fin_steps}")
    a, b = params_of(scaled), params_of(plain)
    diff = max(share_of_scale(a[k], b[k]) for k in a)

    over_cfg = cfg.replace(alpha=1000.0)
    over = train.create_train_state(over_cfg, 100, state_dict=sd,
                                    loss_scaling=True)
    top = float(np.finfo(np.float32).max)
    over.dynamic_scale.scale = top
    before = {k: v.clone() for k, v in over.model.state_dict().items()}
    _, over_loss = train.make_train_step(over_cfg)(
        over, points, np.asarray(labels) + 10.0)
    changed = [k for k, v in over.model.state_dict().items()
               if "num_batches" not in k and not torch.equal(v, before[k])]
    half = float(np.float32(top) * np.float32(0.5))
    require(not changed, f"skipped step changed {changed}")
    require(over.step == 1 and over.tx.count == 0
            and over.dynamic_scale.scale == half
            and over.dynamic_scale.fin_steps == 0,
            f"overflow step: step {over.step}, count {over.tx.count}, "
            f"scale {over.dynamic_scale.scale}")
    return {"launches": launches, "result": {
        "phase": "loss_scaling", "card": card(), "fused_impl": cfg.fused_impl,
        "compute_dtype": cfg.compute_dtype, "batch": TRAIN_BATCH,
        "loss_scaled": float(loss), "loss_unscaled": float(plain_loss),
        "params_max_diff_of_scale_vs_unscaled": diff, "step_ms": ms,
        "launches": launches, "scale": ds.scale,
        "overflow": {"loss": float(over_loss), "skipped": True,
                     "scale_after": over.dynamic_scale.scale,
                     "step": over.step, "update_count": over.tx.count}}}


def flat_yaml(cfg, path: str) -> str:
    """`cfg` as a YAML file in the reference's flat layout."""
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump({k: list(v) if isinstance(v, tuple) else v
                        for k, v in dataclasses.asdict(cfg).items()
                        if not isinstance(v, dict)}, f)
    return path


def cli_phase(cfg, gen_out: str, root: str, device) -> dict:
    """Phase 27: the CLIs in-process on phase 22's generated pairs.
    `train --impl affine --bf16 --epochs 1 -s --train_skip 1 --valid_skip
    1` (K5 and K6 once a step, K3 once a step and once a validation batch,
    K2 once a validation batch), `-e` (resumed: K3 and K2 once a
    validation batch), `predict` from the checkpoint directory under a
    YAML at the serving settings (K1, K3 and K2 once; elevation and labels
    equal to the engine's), `convert_checkpoint` both ways bit-equal."""
    from gndnet_tpu_torch.checkpoint import CheckpointManager, load_weights
    from gndnet_tpu_torch.scripts import convert_checkpoint as convert_cli
    from gndnet_tpu_torch.scripts import predict as predict_cli
    from gndnet_tpu_torch.scripts import train as train_cli

    data = os.path.join(root, "cli_data")
    os.makedirs(data)
    os.symlink(os.path.join(gen_out, "sequences"),
               os.path.join(data, "training"))
    work = os.path.join(root, "cli_run")
    base = ["--config", "kitti_sem", "--data_dir", data, "--workdir", work,
            "--train_skip", "1", "--valid_skip", "1", "--impl", "affine",
            "--bf16"]
    frames = EVAL_FRAMES
    steps = frames // TRAIN_BATCH
    batches = -(-frames // TRAIN_BATCH)
    out = {"phase": "cli", "card": card(), "frames": frames,
           "batch": TRAIN_BATCH}
    launches = {}
    reset_launches()
    t0 = time.perf_counter()
    hist = train_cli.main(base + ["--epochs", "1", "-s"])
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    launches["cli_train"] = read_launches((K3, K5, K6, K2), "cli_train")
    for fn, k in ((K5, steps), (K6, steps), (K3, steps + batches),
                  (K2, batches)):
        require(fn.launches == k, f"train CLI: {fn.__name__} launched "
                                  f"{fn.launches} times, not {k}")
    require(np.isfinite(hist["lowest_loss"]), f"train CLI {hist}")
    ckpt_dir = os.path.join(work, "checkpoints")
    require(CheckpointManager(ckpt_dir).steps() == [1], "train CLI steps")
    reset_launches()
    evaluated = train_cli.main(base + ["-e"])
    launches["cli_evaluate"] = read_launches((K3, K2), "cli_evaluate")
    for fn in (K3, K2):
        require(fn.launches == batches, f"-e: {fn.__name__} launched "
                                        f"{fn.launches} times")
    d_valid = abs(evaluated["valid_loss"][-1] - hist["valid_loss"][-1])
    require(d_valid <= 1e-4 * abs(hist["valid_loss"][-1]),
            f"-e validation vs the trained run's: {d_valid}")
    out["train"] = {"train_loss": hist["train_loss"],
                    "valid_loss": hist["valid_loss"],
                    "evaluate_valid_loss": evaluated["valid_loss"],
                    "steps": steps}

    serving = serving_config(SHIPPED["kitti_sem"]())
    yaml_path = flat_yaml(serving, os.path.join(root, "serving.yaml"))
    scan = os.path.join(gen_out, "sequences", "00", "reduced_velo",
                        "000000.npy")
    reset_launches()
    elev, labels = predict_cli.main(["--config", yaml_path, "--pcl", scan,
                                     "--resume", ckpt_dir])
    launches["cli_predict"] = read_launches((K1, K3, K2), "cli_predict")
    for fn in (K1, K3, K2):
        require(fn.launches == 1, f"predict: {fn.__name__} launched "
                                  f"{fn.launches} times, not once")
    engine = GroundInferenceEngine(serving, load_weights(ckpt_dir),
                                   device=device)
    want_elev, want_labels = engine.infer(predict_cli.load_cloud(
        scan, serving.input_features, serving.lidar_height,
        serving.shift_cloud))
    require(np.array_equal(elev, want_elev)
            and np.array_equal(labels, want_labels),
            "predict CLI vs the engine")
    out["predict"] = {"points": int(labels.shape[0]),
                      "ground_share": float((labels == 0).mean()),
                      "elevation_range": [float(elev.min()),
                                          float(elev.max())]}

    src = os.path.join(ckpt_dir, "checkpoint.pth.tar")
    pth = os.path.join(root, "converted.pth.tar")
    back = os.path.join(root, "converted_dir")
    convert_cli.main(["--config", "kitti_sem", "--from-dir", ckpt_dir,
                      "--to-torch", pth])
    convert_cli.main(["--config", "kitti_sem", "--from-torch", pth,
                      "--to-dir", back])
    first = torch.load(src, weights_only=False)["state_dict"]
    for ckpt in (torch.load(pth, weights_only=False),
                 CheckpointManager(back).restore()):
        require(ckpt["state_dict"].keys() == first.keys() and all(
            torch.equal(ckpt["state_dict"][k], v) for k, v in first.items()),
            "convert_checkpoint is not bit-equal")
    out["convert_checkpoint"] = {"tensors": len(first), "bit_equal": True}
    out["launches"] = launches
    return {"launches": launches, "result": out}


PAR_RANKS = 2            # rank processes of phase 28
PAR_SCANS = 4            # scans a rank serves in the spatial runs
PAR_STEPS = 3            # timed bf16 dp steps, after one warm step
PAR_TIMEOUT_S = 600.0
# f32 spatial inference against the unsharded forward, the JAX package's
# own tolerance (tests/test_parallel.py)
PAR_INFER_RTOL, PAR_INFER_ATOL = 1e-4, 1e-5
# a mesh train step against the single-device step on the whole batch,
# the JAX package's tolerances (tests/test_parallel.py): loss, parameters,
# batch-norm running statistics
PAR_LOSS_RTOL = 1e-5
PAR_PARAM_RTOL, PAR_PARAM_ATOL = 1e-3, 1e-5
PAR_STAT_RTOL, PAR_STAT_ATOL = 1e-4, 1e-6


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def parallel_ranks(rank, world, device, runs) -> dict:
    """Phase 28's rank side, run by `multihost.spawn` in each rank process:
    every run of `runs` on a fresh (dp, sp) mesh, through the entry points
    a user calls (`parallel.mesh`, `parallel.spatial`).  Returns per run
    this rank's mesh index, its kernel launches by wrapper (counted from
    after a warm call), host-clock ms a step or a scan, and the losses,
    the outputs or (f32 steps) the state dict."""
    from gndnet_tpu_torch.parallel import mesh as pmesh
    from gndnet_tpu_torch.parallel import spatial

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out = {}
    for run in runs:
        cfg, dp, sp = run["cfg"], run["dp"], run["sp"]
        mesh = pmesh.make_mesh(dp, sp)
        res = {"dp": mesh.get_local_rank("dp"),
               "sp": mesh.get_local_rank("sp")}
        if run["kind"] == "train":
            state = train.create_train_state(cfg, 100, state_dict=run["sd"],
                                             device=device)
            pmesh.replicate(mesh, state)
            step = (spatial.make_spmd_train_step if sp > 1 else
                    pmesh.make_dp_train_step)(cfg, mesh)
            batch = pmesh.shard_batch(mesh, (run["points"], run["labels"]),
                                      device)
            losses = []
            if run["warm"]:
                losses.append(float(step(state, *batch)[1]))
            _sync(device)
            for fn in COUNTERS:
                fn.launches = 0
            t0 = time.perf_counter()
            for _ in range(run["steps"]):
                losses.append(float(step(state, *batch)[1]))
            _sync(device)
            res["ms_per_step"] = (time.perf_counter() - t0) * 1e3 / run[
                "steps"]
            res["losses"] = losses
            if not run["warm"]:
                res["state_dict"] = {k: v.detach().cpu() for k, v in
                                     state.model.state_dict().items()}
        else:
            model = GroundEstimatorNet(cfg, device=device)
            model.load_state_dict(run["sd"])
            infer = spatial.make_spatial_infer(cfg, mesh)
            local = pmesh.shard_batch(mesh, (run["points"],), device)[0]
            infer(model, local[:1])
            _sync(device)
            for fn in COUNTERS:
                fn.launches = 0
            t0 = time.perf_counter()
            outs = [infer(model, local[i:i + 1])
                    for i in range(local.shape[0])]
            _sync(device)
            res["ms_per_scan"] = (time.perf_counter() - t0) * 1e3 / len(outs)
            res["out"] = torch.cat(outs).cpu()
        res["launches"] = {fn.__name__: fn.launches for fn in COUNTERS}
        out[run["name"]] = res
    return out


def compute_mode() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def parallel_phase(cfg, sd, rng, n_points: int, device) -> dict:
    """Phase 28: the multi-GPU paths in PAR_RANKS rank processes at
    kitti_sem's full width.  With one card both ranks share it over gloo
    (NCCL refuses two ranks on one device); with two or more, one card
    each over NCCL (`multihost.choose_backend`).  Runs, each against its
    single-device counterpart in this process on the same card:

    a) `make_dp_train_step` dp=2 (one scan a rank) at float32 / 'highest',
       TF32 off, one step against the B=2 single-device step (loss,
       parameters, batch-norm statistics at the JAX tests' tolerances);
       K4 and K6 launched in each rank;
    b) the dp=2 bf16 affine step: K3, K5 and K6 once a step in each rank,
       losses finite;
    c) `make_spatial_infer` sp=2 (slabs of 52 rows, 4 of them padding) at
       float32 against the unsharded forward (rtol 1e-4, atol 1e-5), and
       at the serving settings: K1, K3 and K2 once a scan in each rank,
       within SERVE_MANY_ELEV_ATOL of the unsharded forward;
    d) `make_spmd_train_step` sp=2 at float32, one step against the same
       single-device step as a);
    e) fine_grid through 'affine' at sp=2 (ny 250, slabs of 128): K10, K3
       and K2 once a scan in each rank.

    The f32 steps run at beta=0 (no smoothness term): where the map is
    flat, its second differences are rounding noise around 0 whose sign
    |.|'s gradient takes, so any two batchings of one step differ there
    (tests/test_torch_parallel.py measures 1.39x the parameter tolerance,
    for JAX's own dp step as for the port's).  Times are host-clock ms of
    ranks that may share one card: a functional run, not a scaling
    figure."""
    cards = torch.cuda.device_count() if device == "cuda" else 0
    backend = multihost.choose_backend(device, PAR_RANKS)
    mode = compute_mode() if device == "cuda" else "cpu"
    require(cards >= 2 or "exclusive" not in mode.lower(),
            f"one card in compute mode {mode} admits one process")
    cfg32 = cfg.replace(compute_dtype="float32", matmul_precision="highest",
                        beta=0.0)
    points, labels = synthetic_labelled_batch(cfg, rng, TRAIN_BATCH,
                                              n_points)
    scans = np.stack([synthetic_scan(cfg, rng, n_points)
                      for _ in range(PAR_SCANS)])
    fine = serving_config(SHIPPED["fine_grid"]())
    fine_sd = init_state_dict(fine, seed=SEED)
    set_bn_stats(fine_sd, rng)
    fine_scans = np.stack([synthetic_scan(fine, rng, n_points)
                           for _ in range(2)])
    common = dict(points=points, labels=labels, sd=sd)
    runs = [
        dict(name="dp_train_f32", kind="train", cfg=cfg32, dp=2, sp=1,
             steps=1, warm=False, **common),
        dict(name="dp_train", kind="train", cfg=cfg, dp=2, sp=1,
             steps=PAR_STEPS, warm=True, **common),
        dict(name="spatial_infer_f32", kind="infer", cfg=cfg32, dp=1, sp=2,
             sd=sd, points=scans[:2]),
        dict(name="spatial_infer", kind="infer", cfg=cfg, dp=1, sp=2, sd=sd,
             points=scans),
        dict(name="spmd_train_f32", kind="train", cfg=cfg32, dp=1, sp=2,
             steps=1, warm=False, **common),
        dict(name="spatial_infer_fine_grid", kind="infer", cfg=fine, dp=1,
             sp=2, sd=fine_sd, points=fine_scans)]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="gndnet_ranks_") as work:
        ranks = multihost.spawn("chip_smoke:parallel_ranks", PAR_RANKS,
                                kwargs=dict(runs=runs), device=device,
                                workdir=work,
                                timeout=PAR_TIMEOUT_S)
    rank_seconds = time.perf_counter() - t0

    # the single-device references, on this process's card
    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        single = train.create_train_state(cfg32, 100, state_dict=sd,
                                          device=device)
        single_loss = float(train.make_train_step(cfg32)(
            single, points, labels)[1])
        want_sd = {k: v.detach().cpu()
                   for k, v in single.model.state_dict().items()}
        unsharded = {}
        for name, c, s, x in (("spatial_infer_f32", cfg32, sd, scans[:2]),
                              ("spatial_infer", cfg, sd, scans),
                              ("spatial_infer_fine_grid", fine, fine_sd,
                               fine_scans)):
            model = GroundEstimatorNet(c, device=device)
            model.load_state_dict(s)
            unsharded[name] = torch.cat([
                model.fused(torch.from_numpy(x[i:i + 1]).to(device)).cpu()
                for i in range(x.shape[0])])
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = prev

    per_scan = {"spatial_infer_f32": ((K1, K3, K2), 2),
                "spatial_infer": ((K1, K3, K2), PAR_SCANS),
                "spatial_infer_fine_grid": ((K10, K3, K2), 2)}
    per_step = {"dp_train": ((K3, K5, K6), PAR_STEPS)}
    launched = {"dp_train_f32": (K4, K6), "spmd_train_f32": (K4, K6)}
    paths, runs_out = {}, {}
    for run in runs:
        name = run["name"]
        res = [r[name] for r in ranks]
        for r, rr in enumerate(res):
            paths[f"parallel_{name}_rank{r}"] = rr["launches"]
            wrappers, n = per_scan.get(name) or per_step.get(name) or (
                launched[name], None)
            for fn in wrappers:
                got = rr["launches"][fn.__name__]
                require(got > 0 if n is None else got == n,
                        f"{fn.__name__} launched {got} times in rank {r} of "
                        f"parallel {name}" + ("" if n is None else
                                              f", not {n}"))
        row = {"ranks": [{k: v for k, v in rr.items()
                          if k in ("dp", "sp", "launches", "losses",
                                   "ms_per_step", "ms_per_scan")}
                         for rr in res]}
        if name in unsharded:
            want = unsharded[name]
            for rr in res:
                require(torch.equal(rr["out"], res[0]["out"]),
                        f"parallel {name}: sp ranks disagree")
            got = res[0]["out"]
            require(got.shape == want.shape
                    and bool(torch.isfinite(got).all()),
                    f"parallel {name}: output shape / finite")
            err = float((got - want).abs().max())
            row["max_abs_err_vs_unsharded"] = err
            if name == "spatial_infer_f32":
                ok = torch.allclose(got, want, rtol=PAR_INFER_RTOL,
                                    atol=PAR_INFER_ATOL)
                row["rtol_atol"] = [PAR_INFER_RTOL, PAR_INFER_ATOL]
            else:
                ok = err <= SERVE_MANY_ELEV_ATOL
                row["atol"] = SERVE_MANY_ELEV_ATOL
            require(ok, f"parallel {name}: {err} from the unsharded forward")
        elif name.endswith("_f32"):
            loss = res[0]["losses"][0]
            rel = abs(loss - single_loss) / abs(single_loss)
            require(rel <= PAR_LOSS_RTOL, f"parallel {name}: loss {loss} "
                                          f"against single {single_loss}")
            worst = 0.0
            for k, w in want_sd.items():
                if not w.is_floating_point():
                    continue
                stat = "running" in k
                rt = PAR_STAT_RTOL if stat else PAR_PARAM_RTOL
                at = PAR_STAT_ATOL if stat else PAR_PARAM_ATOL
                g = res[0]["state_dict"][k]
                share = float(((g - w).abs() / (at + rt * w.abs())).max())
                worst = max(worst, share)
                for rr in res[1:]:
                    require(torch.equal(rr["state_dict"][k], g),
                            f"parallel {name}: ranks disagree on {k}")
            require(worst <= 1.0, f"parallel {name}: state {worst} of the "
                                  "tolerance from the single-device step")
            row.update(loss=loss, single_loss=single_loss, loss_rel=rel,
                       worst_share_of_tolerance=worst)
        else:
            losses = [v for rr in res for v in rr["losses"]]
            require(all(np.isfinite(losses)), f"parallel {name}: losses "
                                              f"{losses}")
        runs_out[name] = row
    return {"launches": paths, "result": {
        "phase": "parallel", "backend": backend, "cards": cards,
        "ranks": PAR_RANKS, "compute_mode": mode,
        "nvidia_smi": card() if device == "cuda" else "cpu",
        "timing": "host clock in each rank, ranks sharing one card where "
                  "cards < ranks: a functional run, not a scaling figure",
        "seconds_ranks": rank_seconds, "single_loss_f32": single_loss,
        "runs": runs_out}}


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
    """Phases 3-28 on `device`; returns the kernels line's entries."""
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
    aot = serve_aot(cfg, sd, rng, n_points, device)
    paths.update(aot["launches"])
    emit(aot["result"])
    emit(pipelined(aot["engine"], aot["scans"], rng, n_points))
    emit(streaming(aot["engine"], rng, n_points))

    with tempfile.TemporaryDirectory(prefix="gndnet_smoke_") as root:
        gen = generate(cfg, rng, root, device)
        emit(gen["result"])
        evaluated = evaluate_phase(cfg, sd, gen["sequence"], gen["out"],
                                   device)
        paths.update(evaluated["launches"])
        emit(evaluated["result"])
        trained = train_augmented(gen["raw"], root, device)
        paths["train_augmented"] = trained["launches"]
        emit(trained["result"])
        emit(pillar_path(rng, n_points, device))
        scaled = loss_scaling(cfg, sd, rng)
        paths["loss_scaling"] = scaled["launches"]
        emit(scaled["result"])
        clis = cli_phase(cfg, gen["out"], root, device)
        paths.update(clis["launches"])
        emit(clis["result"])
    par = parallel_phase(cfg, sd, rng, n_points, device)
    paths.update(par["launches"])
    emit(par["result"])

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
