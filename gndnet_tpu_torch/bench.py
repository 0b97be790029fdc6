"""The system's benchmark on the card: one JSON line per mode.

    python -m gndnet_tpu_torch.bench [--mode device|e2e|single|batched|train|
                                      stream|accuracy|replay|all] [--iters N]

Counterpart of the repository's `bench.py`, mode for mode, with its flags
and defaults and `--device` (the card unless `--device cpu`; without a card
and without that flag it raises).  Each line carries `bench.py`'s keys for
its mode (`metric`, `value`, `unit`, `vs_baseline` against the reference's
55 Hz, `mode`, `config`, `impl` and the mode's extras), and adds:

* `device`: the platform ("gpu" or "cpu"), the card's name and its power
  limit in watts, as `nvidia-smi --query-gpu=name,power.limit` gives them;
* `runs_hz`: the rate of every timed run, so the spread shows;
* for the serving modes, the engine that gave `value` and its counts:
  `scans` it served, `replays` and `captures` of its CUDA graphs and
  `eager_scans` it ran eagerly (the graph's warm-up and capture
  included: `GroundInferenceEngine.counts`); and under `eager`
  the same measurement through an engine without a graph;
* for `train`, `batched` and `e2e --burst`, `value` is the program
  replayed as one CUDA graph per shape (the train step, the B=`--batch`
  forward, `infer_many`), with its `replays` and the calls it ran
  outside a replay (`eager_steps`, `eager_calls`, `eager_scans`: the
  warm-up and the capture), and the same program run eagerly under
  `eager`.

The unit of work is one 100 000-point scan: shift, bin, PFN, canvas,
SegNet, elevation map, per-point labels.  `device`, `e2e` / `single`,
`replay` and `stream` serve it through the engine as the port serves it
from a warm start (`aot_save`, then `aot_load`: one CUDA graph replay a
scan of the recorded bucket); `batched` runs `GroundEstimatorNet.fused`
at B=`--batch`; `train` takes `make_train_step` steps; `accuracy` trains
on the reference's 5-frame KITTI fixture and scores a held-out frame.

Every rate is anchored on a host scalar that depends on every result, read
after `torch.cuda.synchronize()`.  On a `--device cpu` run the line says
`"platform": "cpu"` and carries no utilization fields: the CPU has no row
in `utils.perf_model`, and a CPU time is no device metric.

The fixture is read from `$GNDNET_REFERENCE_DIR/data/training/seq_000`
(`reduced_velo/*.npy` clouds, `gnd_labels/*.npy` grids) where that
variable names the reference's checkout; otherwise scans are synthetic,
drawn as `bench.py` draws them.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import threading
import time

import numpy as np
import torch

from gndnet_tpu_torch import train as tr
from gndnet_tpu_torch._ext import resolve_device
from gndnet_tpu_torch.config import GndNetConfig, load_config
from gndnet_tpu_torch.evaluate import seg_metrics
from gndnet_tpu_torch.infer import GroundInferenceEngine
from gndnet_tpu_torch.io_shim import subsample_beams
from gndnet_tpu_torch.models.gndnet import GroundEstimatorNet
from gndnet_tpu_torch.ops.postproc import segment_cloud
from gndnet_tpu_torch.profile_serve import card
from gndnet_tpu_torch.serving.replay import replay, replay_device
from gndnet_tpu_torch.utils.compile_cache import enable_compilation_cache
from gndnet_tpu_torch.utils.graphs import GraphCache
from gndnet_tpu_torch.utils.perf_model import perf_accounting
from gndnet_tpu_torch.weights import init_state_dict

PACKAGE = os.path.dirname(os.path.abspath(__file__))
CACHE_DIR = os.path.join(PACKAGE, "_build", "bench")   # kernels, AOT files
REFERENCE_ENV = "GNDNET_REFERENCE_DIR"
BASELINE_HZ = 55.0          # the reference's claim (its README.md:15)
RING_SIZE = 512             # device mode: distinct device-resident scans
BATCHED_RING_SCANS = 384    # batched mode: scans in the ring of batches
# the device ring's per-rep z bump: bfloat16(1e-6) cast to float32
BUMP = float(torch.tensor(1e-6, dtype=torch.bfloat16).float())
# bench.py's transfer budget prices the bytes over a 30 MB/s link; kept so
# the budget keys compare with its lines, not a property of the card's host
LINK_BYTES_PER_S = 30e6
TRAIN_RUNS = 4              # train mode: timed runs, after one warm run


def fixture_dir() -> str | None:
    """The reference's 5-frame KITTI fixture directory, or None."""
    ref = os.environ.get(REFERENCE_ENV)
    if not ref:
        return None
    path = os.path.join(ref, "data", "training", "seq_000")
    return path if os.path.isdir(path) else None


def load_scan(cfg: GndNetConfig, sparse_beams: bool = False) -> np.ndarray:
    """The fixture's first scan where the fixture is available, else a
    synthetic one from `np.random.default_rng(0)` (`bench.py`'s draws);
    `sparse_beams` ring-decimates a fixture scan to 32 beams."""
    root = fixture_dir()
    if root is not None:
        pts = np.load(os.path.join(root, "reduced_velo", "000000.npy"))
        pts = pts.astype(np.float32)
        if sparse_beams:
            pts = subsample_beams(pts, num_beams=64, keep_every=2)
    else:
        rng = np.random.default_rng(0)
        n = cfg.num_points
        pts = np.zeros((n, 4), np.float32)
        pts[:, 0] = rng.uniform(cfg.pc_range[0], cfg.pc_range[3], n)
        pts[:, 1] = rng.uniform(cfg.pc_range[1], cfg.pc_range[4], n)
        pts[:, 2] = rng.uniform(-2.0, 1.0, n) - cfg.lidar_height
        pts[:, 3] = rng.uniform(0, 1, n)
    return pts[:, : cfg.input_features]


def load_fixture_frames(cfg: GndNetConfig, n_frames: int = 5,
                        num_points: int | None = None, seed: int = 0):
    """(clouds (n, N, F) float32, labels (n, 100, 100) float32) of the
    fixture, each cloud subsampled to `num_points` by
    `np.random.default_rng(seed)`; None without the fixture."""
    root = fixture_dir()
    if root is None:
        return None
    rng = np.random.default_rng(seed)
    clouds, labels = [], []
    for i in range(n_frames):
        c = np.load(os.path.join(root, "reduced_velo", f"{i:06d}.npy"))
        c = c.astype(np.float32)
        if num_points is not None and num_points < len(c):
            c = c[rng.choice(len(c), num_points, replace=False)]
        clouds.append(c[:, : cfg.input_features])
        labels.append(np.load(os.path.join(root, "gnd_labels",
                                           f"{i:06d}.npy")).astype(np.float32))
    return np.stack(clouds), np.stack(labels)


def transfer_budget(engine: GroundInferenceEngine, cfg: GndNetConfig,
                    n_points: int) -> dict:
    """Bytes one host-fed scan moves (scan up; f32 elevation map and int8
    labels down) and `relay_bytes_ceiling_hz`, `bench.py`'s rate of those
    bytes over LINK_BYTES_PER_S."""
    up = engine.transfer_bytes(n_points)
    padded = max(engine.bucket, -(-n_points // engine.bucket) * engine.bucket)
    down = cfg.ny * cfg.nx * 4 + padded
    return {"bytes_up_per_scan": up, "bytes_down_per_scan": down,
            "relay_bytes_ceiling_hz": round(LINK_BYTES_PER_S / (up + down),
                                            1)}


def engines(cfg: GndNetConfig, state_dict, device, **kwargs):
    """("graph", engine served from an `aot_save` / `aot_load` warm start
    in CACHE_DIR), then ("eager", engine without a graph), the second made
    when the first has been measured.  A CPU engine has no graph: both
    serve eagerly there."""
    graph = GroundInferenceEngine(cfg, state_dict, device=device, **kwargs)
    os.makedirs(CACHE_DIR, exist_ok=True)
    path = os.path.join(CACHE_DIR, f"aot_{graph.transfer_dtype}"
                        f"_{graph.transfer_features}.json")
    graph.aot_save(path)
    graph.aot_load(path)
    yield "graph", graph
    yield "eager", GroundInferenceEngine(cfg, state_dict, device=device,
                                         **kwargs)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def make_ring(base: torch.Tensor, ring_size: int) -> torch.Tensor:
    """`ring_size` copies of a prepared scan on its device, slot i's z
    moved by i * 1e-4 (`bench.py`'s `make_ring`)."""
    jit_z = (torch.arange(ring_size, dtype=torch.float32,
                          device=base.device) * 1e-4)[:, None, None]
    sel = torch.tensor([0, 0, 1, 0], dtype=torch.float32,
                       device=base.device)[: base.shape[-1]]
    return base[None] + jit_z * sel


def bump(ring: torch.Tensor) -> None:
    """Move every slot's z by BUMP, in place: fresh inputs each rep."""
    ring[..., 2] += BUMP


def ring_rate(dispatch, ring: torch.Tensor, reps: int, device) -> tuple:
    """Serve every slot of `ring` through `dispatch` once as a warm-up,
    then `reps` timed times, bumping z before each.  The scans of a pass
    go back to back with no host sync; each adds sum(pred) (float32) and
    sum(labels) (int64) to device accumulators, whose float32 sum is
    fetched once, after `torch.cuda.synchronize()`.  Returns (seconds of
    each timed pass, the anchor of every pass, the warm-up's first)."""

    def one_pass() -> float:
        psum = torch.zeros((), dtype=torch.float32, device=ring.device)
        lsum = torch.zeros((), dtype=torch.int64, device=ring.device)
        for pts in ring:
            pred, labels = dispatch(pts)
            psum += pred.sum()
            lsum += labels.sum(dtype=torch.int64)
        anchor = psum + lsum.to(torch.float32)
        sync(device)
        return float(anchor)

    anchors = [one_pass()]
    times = []
    for _ in range(reps):
        bump(ring)
        sync(device)
        t0 = time.perf_counter()
        anchors.append(one_pass())
        times.append(time.perf_counter() - t0)
    return times, anchors


def bench_device(cfg: GndNetConfig, state_dict, iters: int,
                 ring_size: int | None = None, device=None) -> dict:
    """Sustained B=1 serving rate on the card: a ring of `ring_size`
    distinct device-resident padded scans, served back to back by each
    engine of `engines` over max(3, iters // ring_size) timed passes;
    rate = ring_size / the fastest pass.  Host-to-device copies are
    excluded (`e2e` measures the full loop).  Returns {"graph": ...,
    "eager": ...}, each {"hz", "runs_hz", "anchor", "scans", "replays",
    "captures", "eager_scans"}."""
    ring_size = ring_size or RING_SIZE
    reps = max(3, iters // ring_size)
    device = resolve_device(device)
    out = {}
    for name, engine in engines(cfg, state_dict, device, threshold=0.08,
                                shift_cloud=True):
        base, _ = engine._prepare(load_scan(cfg))
        ring = make_ring(torch.from_numpy(base).to(device), ring_size)
        times, anchors = ring_rate(engine._dispatch, ring, reps, device)
        del ring
        out[name] = {"hz": ring_size / min(times),
                     "runs_hz": [ring_size / t for t in times],
                     "anchor": anchors[-1], **engine.counts()}
    return out


def bench_e2e(cfg: GndNetConfig, state_dict, iters: int,
              int16: bool = False, features: int | None = None,
              burst: int = 1, device=None) -> tuple:
    """The host-to-card-to-host loop: `infer_pipelined(depth=3)` over
    `iters` host scans (32 distinct buffers, z moved by 1e-4 each), after
    one warm `infer`, through each engine of `engines`.  `burst` > 1 serves
    that many scans a call through `infer_many`, after one warm burst
    (which captures its graph): replaying its CUDA graph ("graph"), then
    with `eager=True` ("eager").  Returns ({engine name: {"hz", "runs_hz",
    counts}}, transfer budget)."""
    device = resolve_device(device)
    kwargs = dict(threshold=0.08, shift_cloud=True,
                  transfer_dtype="int16" if int16 else "float32",
                  transfer_features=features)
    scan = load_scan(cfg)
    scans = [scan + np.float32(i * 1e-4) for i in range(min(iters, 32))]
    out, budget = {}, None
    if burst > 1:
        for name in ("graph", "eager"):
            engine = GroundInferenceEngine(cfg, state_dict, device=device,
                                           **kwargs)
            budget = transfer_budget(engine, cfg, scan.shape[0])
            eager = name == "eager"
            engine.infer_many([scans[j % len(scans)] for j in range(burst)],
                              eager=eager)
            t0 = time.perf_counter()
            done = 0
            for i in range(max(1, iters // burst)):
                done += len(engine.infer_many(
                    [scans[(i * burst + j) % len(scans)]
                     for j in range(burst)], eager=eager))
            hz = done / (time.perf_counter() - t0)
            out[name] = {"hz": hz, "runs_hz": [hz], **engine.counts()}
        return out, budget
    for name, engine in engines(cfg, state_dict, device, **kwargs):
        budget = transfer_budget(engine, cfg, scan.shape[0])
        engine.infer(scans[0])
        stream = [scans[i % len(scans)].copy() for i in range(iters)]
        t0 = time.perf_counter()
        n_out = sum(1 for _ in engine.infer_pipelined(stream, depth=3))
        hz = n_out / (time.perf_counter() - t0)
        out[name] = {"hz": hz, "runs_hz": [hz], **engine.counts()}
    return out, budget


def bench_batched(cfg: GndNetConfig, state_dict, iters: int,
                  batch: int = 16, ring_size: int | None = None,
                  device=None) -> dict:
    """Batched throughput: `GroundEstimatorNet.fused` at B=`batch` over a
    ring of max(4, BATCHED_RING_SCANS // batch) distinct device-resident
    batches, as `bench_device` (z bumped by 1e-6 before each timed pass);
    rate = ring_size * batch / the fastest pass.  Each slot's scans are
    the one scan with z moved by a uniform draw in [0, 1e-4) from a
    `torch.Generator` seeded with 0 (not `bench.py`'s `PRNGKey(0)`
    draws, which another generator cannot give).  Runs through one CUDA
    graph of the call ("graph", `utils.graphs.GraphCache`; eager on the
    CPU), then eagerly ("eager").  Returns {name: {"hz", "runs_hz",
    "anchor", "calls", "replays", "eager_calls"}}."""
    device = resolve_device(device)
    ring_size = ring_size or max(4, BATCHED_RING_SCANS // batch)
    model = GroundEstimatorNet(cfg, device=device)
    model.load_state_dict(state_dict)
    scan = torch.from_numpy(load_scan(cfg)).to(device)
    gen = torch.Generator().manual_seed(0)
    jit_z = torch.rand((ring_size, batch, 1, 1), generator=gen) * 1e-4
    sel = torch.zeros(scan.shape[-1], dtype=torch.float32, device=device)
    sel[2] = 1
    base = scan[None, None] + jit_z.to(device) * sel
    out = {}
    for name in ("graph", "eager"):
        graph = GraphCache(model.fused) if name == "graph" else None
        fused = graph or model.fused
        ring = base.clone()
        calls = 0

        def one_pass() -> float:
            nonlocal calls
            acc = torch.zeros((), dtype=torch.float32, device=device)
            for pts in ring:
                acc += fused(pts).sum()
                calls += 1
            sync(device)
            return float(acc)

        anchor = one_pass()
        times = []
        for _ in range(max(3, iters // ring_size)):
            ring[..., 2] += 1e-6
            sync(device)
            t0 = time.perf_counter()
            anchor = one_pass()
            times.append(time.perf_counter() - t0)
        out[name] = {"hz": ring_size * batch / min(times),
                     "runs_hz": [ring_size * batch / t for t in times],
                     "anchor": anchor, "calls": calls,
                     "replays": graph.replays if graph else 0,
                     "eager_calls": graph.eager_calls if graph else calls}
    return out


def bench_train(cfg: GndNetConfig, iters: int, batch: int = 16,
                sparse_beams: bool = False, device=None) -> dict:
    """Training throughput: runs of reps = max(4, min(iters, 16))
    `make_train_step` steps at B=`batch` (step i's points moved by
    i * 1e-6), each anchored on the summed losses plus a sum over the
    parameters; one warm run, then the best of TRAIN_RUNS.  The step
    updates the state in place, so the parameters, buffers, optimizer
    and step count are restored in place from a copy before every run,
    outside the timed window: every run starts from the same state.  The
    fixture's frames (tiled over the batch, with their labels) where the
    fixture is there and its grid matches, else the scan broadcast to B
    with zero labels.  First through the step's CUDA graph ("graph"; the
    warm run captures it), then with `eager=True` ("eager"), each from the
    same state.  Returns {name: {"hz", "runs_hz", "anchor", "steps",
    "first_losses", "replays", "eager_steps"}}."""
    device = resolve_device(device)
    frames = None if sparse_beams else load_fixture_frames(cfg)
    if frames is not None and frames[1].shape[-2:] == (cfg.ny, cfg.nx):
        clouds, lbls = frames
        sel = [i % len(clouds) for i in range(batch)]
        pts, labels = clouds[sel], lbls[sel]
    else:
        scan = load_scan(cfg)
        pts = np.broadcast_to(scan[None], (batch,) + scan.shape).copy()
        labels = np.zeros((batch, cfg.ny, cfg.nx), np.float32)
    pts = torch.from_numpy(pts).to(device)
    labels = torch.from_numpy(labels).to(device)
    reps = max(4, min(iters, 16))
    state = tr.create_train_state(cfg, steps_per_epoch=100, device=device)
    saved = (copy.deepcopy(state.model.state_dict()),
             copy.deepcopy(state.tx.state_dict()), state.step)

    def restore() -> None:
        model_sd, tx_sd, step_count = saved
        state.model.load_state_dict(model_sd)
        state.tx.load_state_dict(tx_sd)
        state.step = step_count

    out = {}
    for name in ("graph", "eager"):
        step = tr.make_train_step(cfg, eager=name == "eager")

        def chained() -> tuple:
            acc = torch.zeros((), dtype=torch.float32, device=device)
            losses = []
            for i in range(reps):
                _, loss = step(state, pts + i * 1e-6, labels)
                losses.append(loss)
                acc += loss
            for p in state.model.parameters():
                acc += p.detach().float().sum()
            sync(device)
            return float(acc), losses[0]

        restore()
        chained()
        times, first_losses = [], []
        for _ in range(TRAIN_RUNS):
            restore()
            sync(device)
            t0 = time.perf_counter()
            anchor, first = chained()
            times.append(time.perf_counter() - t0)
            first_losses.append(float(first))
        out[name] = {"hz": reps * batch / min(times),
                     "runs_hz": [reps * batch / t for t in times],
                     "anchor": anchor, "steps": (TRAIN_RUNS + 1) * reps,
                     "first_losses": first_losses, "replays": step.replays,
                     "eager_steps": step.eager_steps}
    return out


def bench_accuracy(cfg: GndNetConfig, epochs: int = 150, holdout: int = 4,
                   seed: int = 0, frames=None, device=None) -> dict:
    """The fixture's accuracy gate: train the configuration from seeded
    weights on the fixture's frames but `holdout` (one full-batch step an
    epoch), then score the held-out frame: height RMSE before and after,
    and the IoU / precision / recall of its segmentation against the one
    its ground-truth grid gives at the same threshold (0.08, and the sweep
    0, 0.08, 0.16).  Gates: RMSE <= 0.14 m, IoU >= 0.77, precision >= 0.93,
    recall >= 0.80.  `frames` = (clouds, labels) replaces the fixture.
    Raises FileNotFoundError without either."""
    device = resolve_device(device)
    if frames is None:
        frames = load_fixture_frames(cfg)
    if frames is None:
        raise FileNotFoundError(
            "reference fixture dataset not available (set "
            f"{REFERENCE_ENV} to a checkout holding data/training/seq_000)")
    clouds, labels = frames
    tr_idx = [i for i in range(len(clouds)) if i != holdout]

    def dev(a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=device)

    pts, lbl = dev(clouds[tr_idx]), dev(labels[tr_idx])
    ho_pts = dev(clouds[holdout:holdout + 1])
    ho_lbl = dev(labels[holdout:holdout + 1])
    ho_cloud = dev(clouds[holdout][:, :3])
    state = tr.create_train_state(cfg, steps_per_epoch=1, seed=seed,
                                  device=device)
    step = tr.make_train_step(cfg)
    model = state.model

    def predict() -> torch.Tensor:
        return model.fused(ho_pts)

    def rmse() -> float:
        return float(torch.sqrt(torch.mean((predict() - ho_lbl) ** 2)))

    seg_threshold = 0.08    # the reference's predict operating point
    cell = float(cfg.voxel_size[0])

    def seg_of(elevation: torch.Tensor, thr: float) -> np.ndarray:
        return segment_cloud(ho_cloud, cfg.grid_range, cell, elevation.T,
                             threshold=thr).cpu().numpy()

    def fixture_seg_metrics(thr: float = seg_threshold) -> tuple:
        return seg_metrics(seg_of(predict()[0], thr), seg_of(ho_lbl[0], thr))

    before = rmse()
    iou_before = fixture_seg_metrics()[0]
    t0 = time.perf_counter()
    losses = [step(state, pts, lbl)[1] for _ in range(epochs)]
    after = rmse()
    dt = time.perf_counter() - t0
    iou, precision, recall = fixture_seg_metrics()
    sweep = {}
    for thr in (0.0, 0.08, 0.16):
        i_, p_, r_ = fixture_seg_metrics(thr)
        sweep[f"thr_{thr:g}"] = {"iou": round(i_, 4),
                                 "precision": round(p_, 4),
                                 "recall": round(r_, 4)}
    losses = torch.stack(losses).float().cpu().numpy()
    if not np.isfinite(losses).all():
        raise FloatingPointError("non-finite training loss")
    gates = {"gate_m": 0.14, "gate_iou": 0.77, "gate_precision": 0.93,
             "gate_recall": 0.80}
    passed = bool(after <= gates["gate_m"] and iou >= gates["gate_iou"]
                  and precision >= gates["gate_precision"]
                  and recall >= gates["gate_recall"])
    return {"rmse_before": before, "rmse_after": after,
            "iou_before": round(iou_before, 4), "iou": round(iou, 4),
            "precision": round(precision, 4), "recall": round(recall, 4),
            "seg_threshold": seg_threshold, "threshold_sweep": sweep,
            "first_loss": float(losses[0]), "final_loss": float(losses[-1]),
            "epochs": epochs, "train_seconds": round(dt, 1), **gates,
            "passed": passed}


def bench_stream(cfg: GndNetConfig, state_dict, iters: int,
                 int16: bool = True, features: int | None = None,
                 target_hz: float = 0.0, device=None) -> dict:
    """Host-fed streaming through `serving.replay.replay` (a
    `StreamingEngine` on the engine): min(iters, 64) scans, repeated to
    about `iters`, free-wheeling and, with target_hz > 0, paced; int16
    transfer by default.  Through each engine of `engines`: {engine name:
    {"hz" (free-wheeling), "runs_hz", "freewheel", "paced", "target_hz",
    transfer budget, "transfer", "transfer_features", counts}}."""
    device = resolve_device(device)
    scan = load_scan(cfg)
    scans = [scan] * min(iters, 64)
    repeat = max(1, iters // len(scans))
    out = {}
    for name, engine in engines(
            cfg, state_dict, device, threshold=0.16, shift_cloud=True,
            transfer_dtype="int16" if int16 else "float32",
            transfer_features=features):
        d = {"freewheel": replay(engine, scans, target_hz=0.0,
                                 repeat=repeat).as_dict()}
        d["hz"] = d["freewheel"]["sustained_hz"]
        d["runs_hz"] = [d["hz"]]
        if target_hz > 0:
            d["paced"] = replay(engine, scans, target_hz=target_hz,
                                repeat=repeat).as_dict()
            d["target_hz"] = target_hz
        d.update(transfer_budget(engine, cfg, scan.shape[0]))
        d["transfer"] = engine.transfer_dtype
        d["transfer_features"] = engine.transfer_features
        out[name] = {**d, **engine.counts()}
    return out


def bench_replay(cfg: GndNetConfig, state_dict, n_ticks: int,
                 target_hz: float = 55.0, int16: bool = False,
                 device=None) -> dict:
    """`serving.replay.replay_device`: a device-resident scan feed, the
    submit clock and the result fetch on the host, paced at `target_hz`
    and free-wheeling, through each engine of `engines`: {engine name:
    {"hz" (paced), "runs_hz", "paced", "freewheel", "target_hz",
    counts}}."""
    device = resolve_device(device)
    scan = load_scan(cfg)
    out = {}
    for name, engine in engines(
            cfg, state_dict, device, threshold=0.16, shift_cloud=True,
            transfer_dtype="int16" if int16 else "float32"):
        paced = replay_device(engine, scan, target_hz=target_hz,
                              n_ticks=n_ticks)
        free = replay_device(engine, scan, target_hz=0.0, n_ticks=n_ticks)
        out[name] = {"hz": paced.sustained_hz,
                     "runs_hz": [paced.sustained_hz],
                     "paced": paced.as_dict(), "freewheel": free.as_dict(),
                     "target_hz": target_hz, **engine.counts()}
    return out


def device_info(device: torch.device) -> dict:
    """{"platform", "name", "power_limit_w"} of the device a line ran on."""
    if device.type != "cuda":
        return {"platform": "cpu", "name": "cpu", "power_limit_w": None}
    smi = card()
    power = smi.rsplit(",", 1)[-1].strip().split()[0]
    return {"platform": "gpu", "name": torch.cuda.get_device_name(device),
            "nvidia_smi": smi, "power_limit_w": float(power)}


def served(results: dict) -> tuple:
    """(value, extras) of a mode run through a graph and eagerly: the
    graph's rate and counts (the eager run's where it alone ran), and the
    eager run's under `eager` with its rate as `value`."""
    name = "graph" if "graph" in results else "eager"
    extra = {"engine": name, **results[name]}
    value = extra.pop("hz")
    if name == "graph":
        eager = dict(results["eager"])
        extra["eager"] = {"value": round(eager.pop("hz"), 2), **eager}
    return value, extra


class Watchdog:
    """Ends the process with exit code 3 when a mode gives no result
    within `seconds` (re-armed before each mode); 0 disables it."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.timer = None

    def _expire(self) -> None:
        print(f"bench watchdog: no result after {self.seconds:.0f}s in one "
              "mode (a hung build, launch or sync): aborting",
              file=sys.stderr, flush=True)
        os._exit(3)

    def arm(self) -> None:
        self.cancel()
        if self.seconds > 0:
            self.timer = threading.Timer(self.seconds, self._expire)
            self.timer.daemon = True
            self.timer.start()

    def cancel(self) -> None:
        if self.timer is not None:
            self.timer.cancel()
            self.timer = None


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m gndnet_tpu_torch.bench",
        description="Benchmark the port on the card: one JSON line a mode.")
    ap.add_argument("--mode", default="device",
                    choices=["device", "e2e", "single", "batched", "train",
                             "stream", "accuracy", "replay", "all"])
    ap.add_argument("--batch", type=int, default=16,
                    help="batched/train modes: scans per batch (16, the "
                         "reference's largest shipped batch)")
    ap.add_argument("--target_hz", type=float, default=55.0,
                    help="replay/stream modes: paced sensor submit rate")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--epochs", type=int, default=150,
                    help="accuracy mode: full-batch epochs on the 4-frame "
                         "fixture train split")
    ap.add_argument("--f32", action="store_true",
                    help="parity precision (the configuration's float32 "
                         "and 'highest', 'scatter' unless --impl) instead "
                         "of serving bf16 / 'default' / 'affine'")
    ap.add_argument("--int16", action="store_true",
                    help="e2e/replay modes: ship scans as 4 mm fixed-point "
                         "int16 (half the host-to-device bytes; stream "
                         "mode defaults to int16, see --f32_transfer)")
    ap.add_argument("--f32_transfer", action="store_true",
                    help="stream mode: ship scans as float32")
    ap.add_argument("--features", type=int, default=None,
                    help="ship only the leading N point columns (>= 3); "
                         "the rest are zero-filled on the device "
                         "(e2e/stream modes)")
    ap.add_argument("--burst", type=int, default=1,
                    help="e2e/single modes: scans per call (infer_many, "
                         "eager), at K-scan buffering latency")
    ap.add_argument("--config", default="kitti_sem",
                    help="preset name (kitti_sem | fine_grid | "
                         "sparse_32beam | camera | custom_local) or YAML "
                         "path; sparse_32beam beam-decimates a fixture "
                         "scan")
    ap.add_argument("--impl", default=None,
                    choices=[None, "scatter", "affine", "sorted"],
                    help="fused frontend implementation override")
    ap.add_argument("--watchdog", type=float,
                    default=float(os.environ.get("BENCH_WATCHDOG_S", 1800)),
                    help="wall-clock limit per mode in seconds, re-armed "
                         "before each mode; the process exits with code 3 "
                         "when it expires; 0 disables it")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain kernels, no device metric)")
    return ap.parse_args(argv)


def run_mode(mode: str, args, cfg: GndNetConfig, state_dict, device,
             accounting: bool) -> tuple:
    """(value in Hz, extras) of one rate mode."""
    if mode == "device":
        hz, extra = served(bench_device(cfg, state_dict, args.iters,
                                        device=device))
        if accounting:
            extra.update(perf_accounting(cfg, hz))
        extra["note"] = ("device-resident scan ring, scans back to back; "
                         "host I/O excluded (--mode e2e measures the full "
                         "loop)")
    elif mode in ("e2e", "single"):
        res, budget = bench_e2e(cfg, state_dict, args.iters,
                                int16=args.int16, features=args.features,
                                burst=args.burst, device=device)
        hz, extra = served(res)
        extra.update(budget)
        if args.burst > 1:
            extra["burst"] = args.burst
    elif mode == "replay":
        hz, extra = served(bench_replay(
            cfg, state_dict, max(args.iters, 256), target_hz=args.target_hz,
            int16=args.int16, device=device))
        extra["note"] = (f"device-resident scan feed, host submit clock at "
                         f"{args.target_hz} Hz and host result fetch; "
                         "freewheel = unbounded submit rate")
    elif mode == "batched":
        hz, extra = served(bench_batched(cfg, state_dict, args.iters,
                                         batch=args.batch, device=device))
        if accounting:
            extra.update(perf_accounting(cfg, hz, batch=args.batch))
    elif mode == "train":
        hz, extra = served(bench_train(
            cfg, args.iters, batch=args.batch,
            sparse_beams=args.config == "sparse_32beam", device=device))
        if accounting:
            extra.update(perf_accounting(cfg, hz, batch=args.batch,
                                         training=True))
        extra["note"] = (f"make_train_step steps (fwd+bwd+SGD), "
                         f"B={args.batch}; mfu counts fwd+bwd as 3x forward "
                         "FLOPs")
    else:
        hz, extra = served(bench_stream(
            cfg, state_dict, args.iters, int16=not args.f32_transfer,
            features=args.features, target_hz=args.target_hz,
            device=device))
        extra["note"] = ("host-fed StreamingEngine loop (submit, serve on "
                         "its thread, read back)")
    return hz, extra


def main(argv=None) -> int:
    args = parse_args(argv)
    watchdog = Watchdog(args.watchdog)
    watchdog.arm()
    try:
        device = resolve_device(args.device)
        enable_compilation_cache(CACHE_DIR)
        cfg = load_config(args.config)
        if not args.f32:
            cfg = cfg.replace(compute_dtype="bfloat16",
                              matmul_precision="default")
        cfg = cfg.replace(fused_impl=args.impl
                          or ("scatter" if args.f32 else "affine"))
        state_dict = init_state_dict(cfg, seed=0)
        info = device_info(device)
        modes = ([args.mode] if args.mode != "all"
                 else ["device", "batched", "train", "replay"]
                 + (["accuracy"] if args.config == "kitti_sem" else []))
        rc = 0
        for mode in modes:
            watchdog.arm()
            if mode == "accuracy":
                res = bench_accuracy(cfg, epochs=args.epochs, device=device)
                line = {"metric": "holdout height RMSE (m)",
                        "value": round(res["rmse_after"], 4), "unit": "m",
                        "vs_baseline": round(
                            res["rmse_after"] / res["gate_m"], 3)}
                rc = max(rc, 0 if res["passed"] else 1)
            else:
                hz, res = run_mode(mode, args, cfg, state_dict, device,
                                   info["platform"] == "gpu")
                line = {"metric": "scans/sec/chip (Hz)",
                        "value": round(hz, 2), "unit": "Hz",
                        "vs_baseline": round(hz / BASELINE_HZ, 2)}
            print(json.dumps({**line, "mode": mode, "config": args.config,
                              "impl": cfg.fused_impl, "device": info,
                              **res}), flush=True)
        return rc
    finally:
        watchdog.cancel()


if __name__ == "__main__":
    sys.exit(main())
