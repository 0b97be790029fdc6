"""Serving engine: scan -> (elevation map, per-point labels), one scan at a
time, a pipeline of scans, a burst of scans in one batched call, or a
free-wheeling stream.

Counterpart of `gndnet_tpu.infer` (`GroundInferenceEngine` with `_pad`'s
1e9 sentinel and bucket padding, `_prepare`, the int16 transfer option,
`transfer_features`, `transfer_bytes`, `infer`, `infer_async`,
`infer_pipelined`, `infer_many`, `aot_save` / `aot_load`, `warmup`; and
`StreamingEngine`): shift the cloud by the lidar height, run the fused model,
label each point against the elevation map, and return numpy arrays.  The
engine runs on the card unless the caller passes device='cpu'.

On the card a scan goes host -> pinned ring slot -> device on a copy stream,
and the compute stream waits on the copy's event, so copies overlap the
previous scans' compute; a single scan, like a burst's scans, is padded
straight into its pinned slot (`_fill`; a burst's scans on several host
threads), which goes up whole.  A single scan's answer comes back into a
pinned readback slot behind that scan's own event, so fetching it does
not wait for the scans submitted after it.
Where the JAX engine dispatches one compiled XLA executable a scan, the
port launches each operation of `run` from Python, and keeps its CUDA
graphs in one `GraphCache` of `run_many`: `infer_many` replays one per
(K, bucket) shape (JAX's `_run_many` jitted once per K), and `aot_load`
captures the artifact's padded shape as K=1, so a single scan of that
shape is one graph replay.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import os
import threading
import time
import traceback
from collections import deque

import numpy as np
import torch

from gndnet_tpu_torch import _ext, native
from gndnet_tpu_torch.config import GndNetConfig
from gndnet_tpu_torch.models.gndnet import GroundEstimatorNet
from gndnet_tpu_torch.ops import pillarize
from gndnet_tpu_torch.ops.postproc import segment_cloud
from gndnet_tpu_torch.utils.graphs import GraphCache
from gndnet_tpu_torch.utils.profiling import span

_PAD_SENTINEL = 1e9  # pads bin far out of range -> seg label -1, no pillar
PIPELINE_DEPTH = 3   # infer_pipelined's default depth and the ring's slots

_fill_pool = None    # the burst fills' threads, made at the first split fill
_fill_pool_lock = threading.Lock()


def _fill_threads() -> concurrent.futures.ThreadPoolExecutor:
    """The process's pool of `gndnet-fill` threads, made at its first use:
    a burst's caller shares its fill with them, never with PyTorch's
    intra-op pool."""
    global _fill_pool
    with _fill_pool_lock:
        if _fill_pool is None:
            _fill_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=os.cpu_count(), thread_name_prefix="gndnet-fill")
        return _fill_pool


class _HostRing:
    """Pinned host buffers that feed the card from a copy stream.

    `acquire` takes the next slot and holds it, under the ring's lock,
    until `send` copies it up (or `release` gives it back unsent), so a
    slot is written again only after its last copy's event has completed.
    The device tensor a copy produces is handed to the caller's stream
    behind that event (and `record_stream`), so the caching allocator does
    not reuse it while the compute stream reads it."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.slots: list = []       # [pinned host tensor, copy event]
        self.next = 0
        self.held = None            # the slot between acquire and send
        self.allocs = 0             # pinned buffers allocated
        self.lock = threading.Lock()
        self.reserve(slots)

    def reserve(self, slots: int) -> None:
        with self.lock:
            while len(self.slots) < slots:
                self.slots.append([None, None])

    def acquire(self, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        """The next slot's pinned host tensor, of `shape` and `dtype`, to
        write, once its last copy has completed.  The caller holds the
        ring until it calls `send` or `release`."""
        self.lock.acquire()
        try:
            slot = self.slots[self.next % len(self.slots)]
            self.next += 1
            host, done = slot
            if done is not None:
                with span("gndnet.engine.slot_wait"):
                    done.synchronize()
            if host is None or host.shape != tuple(shape) \
                    or host.dtype != dtype:
                slot[0] = host = torch.empty(shape, dtype=dtype,
                                             pin_memory=True)
                self.allocs += 1
        except BaseException:
            self.lock.release()
            raise
        self.held = slot
        return host

    def release(self) -> None:
        """Give the held slot back without a copy."""
        self.held = None
        self.lock.release()

    def send(self) -> torch.Tensor:
        """Copy the held slot to the device on the copy stream, and give
        the ring back: the device tensor, ready on the current stream."""
        slot, self.held = self.held, None
        try:
            with torch.cuda.stream(self.stream):
                dev = slot[0].to(self.device, non_blocking=True)
                slot[1] = torch.cuda.Event()
                slot[1].record(self.stream)
            done = slot[1]
        finally:
            self.lock.release()
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(done)
        dev.record_stream(compute)
        return dev


class _Readback:
    """Pinned host slots that single-scan answers come back into from the
    card.  A slot is [key, map, labels, event]: a pinned (ny, nx) float32
    map and (Np,) int8 label row, keyed by their shapes, and the event of
    its last copy.

    `send` takes a free slot of the answer's shape (allocating one when
    none is free), enqueues the map's and the labels' non-blocking copies
    into it on the current stream, behind the scan's own replay and before
    the next scan's, and records the slot's event; `receive` waits for that
    event alone, copies the answer out into numpy arrays the caller owns,
    and frees the slot.  So a fetch waits for its own scan, not for the
    scans submitted behind it, and in a stream of one shape with d scans in
    flight the engine settles at d slots.  The device tensors need no
    `record_stream`: the copies run on the stream that made them."""

    def __init__(self, device: torch.device):
        self.device = device
        self.free: list = []        # slots no scan holds
        self.allocs = 0             # slots allocated
        self.lock = threading.Lock()

    def send(self, n: int, pred: torch.Tensor, labels: torch.Tensor) -> list:
        key = (tuple(pred.shape), labels.shape[0])
        with self.lock:
            i = next((i for i, s in enumerate(self.free) if s[0] == key),
                     None)
            slot = None if i is None else self.free.pop(i)
        if slot is None:
            slot = [key, torch.empty(key[0], dtype=pred.dtype,
                                     pin_memory=True),
                    torch.empty(key[1], dtype=labels.dtype, pin_memory=True),
                    torch.cuda.Event()]
            with self.lock:
                self.allocs += 1
        _, host_map, host_labels, done = slot
        host_map.copy_(pred, non_blocking=True)
        host_labels[:n].copy_(labels[:n], non_blocking=True)
        done.record(torch.cuda.current_stream(self.device))
        return slot

    def receive(self, n: int, slot: list) -> tuple:
        _, host_map, host_labels, done = slot
        done.synchronize()
        out = host_map.numpy().copy(), host_labels[:n].numpy().copy()
        with self.lock:
            self.free.append(slot)
        return out


class GroundInferenceEngine:
    """Scan -> (elevation map, per-point segmentation) engine.

    Args:
      cfg: model config, any fused_impl ('scatter', 'sorted', 'affine').
      state_dict: weights in the reference's names
        (`weights.state_dict_from_flax`, `weights.init_state_dict` or
        `checkpoint.load_torch_checkpoint(...)['state_dict']`).
      threshold: segmentation threshold (the reference uses 0.08 in
        predict_ground.py:168).
      shift_cloud: add cfg.lidar_height to z first; None uses
        cfg.shift_cloud.
      bucket: pad scans up to a multiple of this many points.
      transfer_dtype: 'float32', or 'int16' to ship scans as 4 mm
        fixed point (half the host-to-device bytes).
      transfer_features: ship only the leading k >= 3 point columns and
        zero-fill the rest on the device.
      device: the card unless 'cpu' is passed; raises if CUDA is missing.

    Each stage of a scan is a host span (`utils.profiling.span`) while a
    profiler collects: `gndnet.engine.submit` (`prepare`, `upload` with its
    `slot_wait` and `stage_copy`, the scan's fill of its pinned slot,
    `dispatch` with the graph's `gndnet.graph.replay`, `capture` or
    `eager`, and in `infer` and `infer_pipelined` `readback`, the answer's
    copies into a pinned slot), then `gndnet.engine.fetch` (the wait for
    that scan's copies alone and the copy out of its slot).  A burst fills
    its slot under `stack` and sends it under `upload`: `prepare`,
    `slot_wait`, `stack`, `upload`, `dispatch`; no `stage_copy`.  `stack`
    is the burst's fill, which the caller shares with `gndnet-fill`
    threads where the process may run on four cores or more.
    `counts()` gives what the engine served.
    """

    QUANT_SCALE = 1.0 / 256.0   # 4 mm resolution, +-128 m range in int16

    def __init__(self, cfg: GndNetConfig, state_dict, threshold: float = 0.08,
                 shift_cloud: bool | None = None, bucket: int = 4096,
                 transfer_dtype: str = "float32",
                 transfer_features: int | None = None, device=None):
        if transfer_dtype not in ("float32", "int16"):
            raise ValueError(f"unsupported transfer_dtype {transfer_dtype!r}")
        k = cfg.input_features if transfer_features is None \
            else int(transfer_features)
        if not 3 <= k <= cfg.input_features:
            raise ValueError(
                f"transfer_features must be in [3, {cfg.input_features}], "
                f"got {transfer_features}")
        self.cfg = cfg
        self.threshold = float(threshold)
        self.shift = cfg.shift_cloud if shift_cloud is None else shift_cloud
        self.bucket = bucket
        self.transfer_dtype = transfer_dtype
        self.transfer_features = k
        self.model = GroundEstimatorNet(cfg, device=device)
        self.model.load_state_dict(state_dict)
        self.device = self.model.device
        self._shift = torch.tensor(
            [0.0, 0.0, cfg.lidar_height if self.shift else 0.0]
            + [0.0] * (cfg.input_features - 3), device=self.device)
        # the CPU engine copies nothing: no pinned memory, no stream.  A
        # burst waits for its answers, so one slot of its own serves every
        # burst, and the single-scan ring keeps its slots' shapes.
        cuda = self.device.type == "cuda"
        self._ring = _HostRing(self.device, PIPELINE_DEPTH) if cuda else None
        self._burst_ring = _HostRing(self.device, 1) if cuda else None
        self._readback = _Readback(self.device) if cuda else None
        self._pad_value = self._quantise(
            np.full(1, _PAD_SENTINEL, np.float32))[0]
        # every graph of the engine: a burst's (K, Np, k), aot_load's scan
        # as (1, Np, k)
        self._graphs = GraphCache(self.run_many)
        self._aot_shape = None  # the (Np, k) of a scan that replays
        self._counted = {"scans": 0, "eager_scans": 0, "pair_sorted": 0,
                         "readbacks": 0, "parallel_fills": 0}
        self._count_lock = threading.Lock()

    def _count(self, key: str, k: int) -> None:
        with self._count_lock:
            self._counted[key] += k

    def counts(self) -> dict:
        """`scans` served (`_dispatch`, `infer_many`), `replays` and
        `captures` of the engine's CUDA graphs (its one `GraphCache`; a
        capture replays once, `aot_load`'s too), and `eager_scans`: the
        scans `run_many` ran outside a replay (`run`, `warmup`, eager
        bursts, and each graph's warm-up and capture, so as many as a
        kernel wrapper counts launches); `slot_allocs`, the pinned buffers
        the rings allocated (one a burst shape in a stream of bursts);
        `pair_sorted`, the scans served through K10's (cell, index) pair
        sort (`_sorts_pairs`), replayed or eager; `readbacks`, the
        single-scan answers fetched through `_read_back` (`infer`,
        `infer_pipelined`, `warmup`), and `readback_allocs`, the pinned
        readback slots allocated (0 on a CPU engine; d in a stream of one
        shape at depth d); `parallel_fills`, the bursts whose fill was
        shared by more than one thread (`_fill_rows`: every burst where the
        process may run on four cores or more, never a single scan)."""
        rings = [r for r in (self._ring, self._burst_ring) if r is not None]
        return {"scans": self._counted["scans"],
                "replays": self._graphs.replays,
                "captures": len(self._graphs.graphs),
                "eager_scans": self._counted["eager_scans"],
                "slot_allocs": sum(r.allocs for r in rings),
                "pair_sorted": self._counted["pair_sorted"],
                "readbacks": self._counted["readbacks"],
                "readback_allocs": (self._readback.allocs
                                    if self._readback is not None else 0),
                "parallel_fills": self._counted["parallel_fills"]}

    def _sorts_pairs(self, k: int, n: int) -> bool:
        """Whether a call of k scans padded to n points sorts its (cell,
        index) pairs with K10: the affine canvas at B=1 on a grid whose
        packed key overflows (`pillarize.pair_keys`, the predicate
        `cell_stream` branches on)."""
        return (k == 1 and self.cfg.fused_impl == "affine"
                and pillarize.pair_keys(self.model.geom.num_cells_3d, n))

    def _padded_len(self, n: int) -> int:
        """The points of a scan of n points after bucket padding."""
        return max(self.bucket, -(-n // self.bucket) * self.bucket)

    def _quantise(self, points: np.ndarray) -> np.ndarray:
        """float32 points in the transfer type."""
        if self.transfer_dtype == "int16":
            return np.clip(np.rint(points / self.QUANT_SCALE),
                           -32768, 32767).astype(np.int16)
        return points

    def _prepare(self, points: np.ndarray) -> tuple:
        """One scan as the engine ships it: (its padded (Np, k) host array
        in the transfer type, its length)."""
        points = np.asarray(points, np.float32)
        out = np.empty((self._padded_len(points.shape[0]),
                        self.transfer_features), self.transfer_dtype)
        self._fill(points, out)
        return out, points.shape[0]

    def _fill(self, points: np.ndarray, out: np.ndarray) -> None:
        """Write a float32 scan into `out`, its (Np, k) padded form (a
        single scan's pinned slot, a row of a burst's, `_prepare`'s array):
        its leading k columns (zeros where it has fewer), `_PAD_SENTINEL`
        rows from its length on, all in the transfer type.  The one writer
        of that layout."""
        n = points.shape[0]
        c = min(points.shape[1], self.transfer_features)
        out[:n, :c] = self._quantise(points[:, :c])
        out[:n, c:] = 0
        out[n:] = self._pad_value

    def transfer_bytes(self, n_points: int) -> int:
        """Host->device bytes one scan of n_points costs through this
        engine's transfer configuration (after bucket padding)."""
        padded = self._padded_len(n_points)
        item = 2 if self.transfer_dtype == "int16" else 4
        return padded * self.transfer_features * item

    def _stage(self, ring, scans: list, shape: tuple, fill: str,
               send: str | None = None) -> torch.Tensor:
        """Acquire the next slot of `ring`, of `shape` ((Np, k) for one
        scan, (K, Np, k) for a burst), fill the float32 `scans` into it
        inside the span `fill` (`_fill_rows`), and send it, inside the span
        `send` where one is named: the scans on the engine's device, ready
        on the current stream.  A fill that raises gives the slot back
        unsent, once nothing writes into it.  A CPU engine (no ring) fills
        an `np.empty` and serves it as it is."""
        dtype = self.transfer_dtype
        out = (np.empty(shape, dtype) if ring is None
               else ring.acquire(shape, getattr(torch, dtype)).numpy())
        try:
            with span(fill):
                self._fill_rows(scans, out.reshape(-1, *shape[-2:]))
        except BaseException:
            if ring is not None:
                ring.release()
            raise
        with span(send) if send else contextlib.nullcontext():
            return torch.from_numpy(out) if ring is None else ring.send()

    def _fill_rows(self, scans: list, rows: np.ndarray) -> None:
        """`_fill` scan i into rows[i].  A burst, on a process that may run
        on four cores or more, is shared by W = min(K, cores // 2) threads:
        the caller and W - 1 fill threads (`_fill_threads`), each taking the
        next whole scan until none is left, so a thread that starts late
        fills fewer; the caller then waits for them all.  Half the cores:
        the copy is bound by the host's memory bandwidth, which four
        threads use up on an 8-core H100 host, and each further thread only
        adds GIL hand-overs (each numpy call of a fill gives the GIL up and
        takes it back).  A single scan, or fewer cores, fills on the
        caller's thread.  An exception is raised only once every thread has
        stopped writing."""
        workers = (min(len(scans), len(os.sched_getaffinity(0)) // 2)
                   if len(scans) > 1 else 1)
        order = iter(range(len(scans)))     # each next() hands out one scan

        def fill_some() -> None:
            for i in order:
                self._fill(scans[i], rows[i])

        if workers < 2:
            fill_some()
            return
        pool, tasks = _fill_threads(), []
        try:
            for _ in range(workers - 1):
                tasks.append(pool.submit(fill_some))
            fill_some()
        finally:
            concurrent.futures.wait(tasks)
        for task in tasks:
            task.result()
        self._count("parallel_fills", 1)

    def _upload(self, points: np.ndarray) -> torch.Tensor:
        """A float32 scan padded into the next slot of the single-scan ring
        and sent: (Np, k) on the engine's device, ready on the current
        stream."""
        shape = (self._padded_len(points.shape[0]), self.transfer_features)
        with span("gndnet.engine.upload"):
            return self._stage(self._ring, [points], shape,
                               "gndnet.engine.stage_copy")

    def device_points(self, padded: torch.Tensor) -> torch.Tensor:
        """Prepared (padded) scans, (Np, k) or stacked (K, Np, k) -> the
        (..., Np, input_features) float32 points the model sees, on the
        device: dequantised, zero-filled, shifted by the lidar height."""
        points = padded.to(self.device, non_blocking=True)
        if self.transfer_dtype == "int16":
            points = points.float() * self.QUANT_SCALE
        missing = self.cfg.input_features - self.transfer_features
        if missing:
            points = torch.nn.functional.pad(points, (0, missing))
        return points + self._shift

    @torch.no_grad()
    def run(self, padded: torch.Tensor, reference: bool = False):
        """Device-side program on a prepared (padded) scan tensor: returns
        (elevation (ny, nx) float32, labels (Np,) int8) on the device.
        `reference=True` takes the plain version of every kernel stage."""
        pred, labels = self.run_many(padded[None], reference=reference)
        return pred[0], labels[0]

    @torch.no_grad()
    def run_many(self, padded: torch.Tensor, reference: bool = False):
        """Device-side program on K prepared scans of one bucket, stacked
        (K, Np, k): one fused call at B=K, then every scan labelled against
        its own map in one batched gather.  Returns (elevation (K, ny, nx)
        float32, labels (K, Np) int8) on the device.  `reference=True`
        takes the plain version of every kernel stage."""
        self._count("eager_scans", padded.shape[0])
        pts = self.device_points(padded)
        pred = self.model.fused(pts, reference=reference)
        labels = segment_cloud(pts, self.cfg.grid_range,
                               self.cfg.voxel_size[0], pred.transpose(1, 2),
                               self.threshold)
        return pred, labels.to(torch.int8)

    def _dispatch(self, padded: torch.Tensor):
        """`run`, or, for the padded shape `aot_load` recorded, the
        engine's graph of `run_many` for that one scan (eager on the
        CPU)."""
        self._count("scans", 1)
        if self._sorts_pairs(1, padded.shape[0]):
            self._count("pair_sorted", 1)
        with span("gndnet.engine.dispatch"):
            if tuple(padded.shape) == self._aot_shape:
                pred, labels = self._graphs(padded[None])
                return pred[0], labels[0]
            with span("gndnet.graph.eager"):
                return self.run(padded)

    def _launch(self, points: np.ndarray) -> tuple:
        """Prepare, upload and dispatch one scan: (n, pred, labels), the
        answer on the device, ready on the current stream."""
        with span("gndnet.engine.prepare"):
            points = np.asarray(points, np.float32)
        pred, labels = self._dispatch(self._upload(points))
        return points.shape[0], pred, labels

    def infer_async(self, points: np.ndarray) -> tuple:
        """Non-blocking submit: returns (n, pred_dev, labels_dev), device
        tensors on the current stream, without waiting for the card.
        Interleave several calls before materialising to overlap the
        host-to-device copies with compute."""
        with span("gndnet.engine.submit"):
            return self._launch(points)

    def _read_back(self, n: int, pred: torch.Tensor,
                   labels: torch.Tensor) -> tuple:
        """Start a scan's answer on its way to the host: (n, what `_fetch`
        takes), on a CUDA engine the pinned readback slot its copies were
        enqueued into, on the CPU the answer's own numpy views."""
        with span("gndnet.engine.readback"):
            if self._readback is None:
                return n, (pred.numpy(), labels[:n].numpy())
            return n, self._readback.send(n, pred, labels)

    def _submit(self, points: np.ndarray) -> tuple:
        """`infer_async` with the answer's readback enqueued in its submit."""
        with span("gndnet.engine.submit"):
            return self._read_back(*self._launch(points))

    def _fetch(self, n: int, slot) -> tuple:
        """The answer `_read_back` started, as numpy arrays the caller owns
        (on the card: once its own copies are done)."""
        with span("gndnet.engine.fetch"):
            self._count("readbacks", 1)
            if self._readback is None:
                return slot
            return self._readback.receive(n, slot)

    def infer(self, points: np.ndarray) -> tuple:
        """points: (N, >=3) float32 (extra columns beyond
        cfg.input_features are ignored, missing ones zero-filled).
        Returns (elevation (ny, nx) np.float32, labels (N,) np.int8 with
        values {1: obstacle, 0: ground, -1: out of grid})."""
        return self._fetch(*self._submit(points))

    def infer_pipelined(self, scans, depth: int = PIPELINE_DEPTH):
        """Generator yielding (elevation, labels) per scan, in submission
        order, with `depth` scans in flight, so the copies overlap compute
        across scans (sustained-throughput serving): a fetch waits for its
        own scan's readback, not for the scans behind it."""
        if depth < 1:
            raise ValueError(f"depth must be at least 1, got {depth}")
        if self._ring is not None:
            self._ring.reserve(depth)
        inflight = deque()
        for scan in scans:
            inflight.append(self._submit(scan))
            if len(inflight) >= depth:
                yield self._fetch(*inflight.popleft())
        while inflight:
            yield self._fetch(*inflight.popleft())

    def infer_many(self, scans, eager: bool = False) -> list:
        """Batched inference of a burst of scans in one device call: all
        scans must fall into one padded bucket.  Each scan is padded
        straight into the burst's pinned slot (`_fill_rows`: on several
        threads where the process may run on four cores or more), the slot
        goes up whole, and on a CUDA engine a burst of K scans replays the
        CUDA graph of `run_many` for its (K, bucket) shape, captured at the
        first such burst (`eager=True` runs `run_many` eagerly instead).
        Returns [(elevation (ny, nx) np.float32, labels (N_i,) np.int8),
        ...] in submission order."""
        with span("gndnet.engine.submit"):
            with span("gndnet.engine.prepare"):
                scans = [np.asarray(s, np.float32) for s in scans]
                shapes = {(self._padded_len(s.shape[0]),
                           self.transfer_features) for s in scans}
                if len(shapes) != 1:
                    raise ValueError(f"scans fall into mixed buckets "
                                     f"{shapes}; pad or split the burst")
            shape = (len(scans), *shapes.pop())
            stack = self._stage(self._burst_ring, scans, shape,
                                "gndnet.engine.stack", "gndnet.engine.upload")
            self._count("scans", len(scans))
            if self._sorts_pairs(*shape[:2]):
                self._count("pair_sorted", 1)
            with span("gndnet.engine.dispatch"):
                if eager:
                    with span("gndnet.graph.eager"):
                        preds, labels = self.run_many(stack)
                else:
                    preds, labels = self._graphs(stack)
        with span("gndnet.engine.fetch"):
            preds, labels = preds.cpu().numpy(), labels.cpu().numpy()
            return [(preds[i], labels[i][:s.shape[0]])
                    for i, s in enumerate(scans)]

    def _example_input(self, n: int | None = None) -> np.ndarray:
        """A padded input of the shape the engine serves."""
        n = n or self.cfg.num_points
        return self._prepare(np.zeros((n, self.transfer_features),
                                      np.float32))[0]

    def aot_save(self, path: str, n: int | None = None) -> int:
        """Build every kernel the engine's path launches (the port's
        compile step) and write the artifact `aot_load` serves from: the
        padded shape of n points (default cfg.num_points), the transfer
        type, and what a graph of it depends on
        (utils/compile_cache.py).  Returns its size in bytes."""
        from gndnet_tpu_torch.utils.compile_cache import save_compiled

        example = self._example_input(n)
        if self.device.type == "cuda":
            _ext.build_all()
        return save_compiled(path, self.device, meta={
            "example_shape": list(example.shape),
            "example_dtype": str(example.dtype),
            "transfer_dtype": self.transfer_dtype,
        })

    def aot_load(self, path: str) -> None:
        """Serve from an `aot_save` artifact: record the padded shape it
        holds (it may differ from the default) and, on a CUDA engine,
        capture the engine's graph of `run_many` for one scan of that shape
        (a flat-plane scan, captured and replayed once); scans of that
        shape replay it, any other shape runs `run` eagerly and is never
        captured.  Raises ValueError if the artifact does not fit this
        engine or process, and whatever the capture raises: a CUDA engine
        never serves eagerly in its stead.  A CPU engine checks the
        artifact and serves eagerly."""
        from gndnet_tpu_torch.utils.compile_cache import load_compiled

        meta = load_compiled(path, self.device)
        saved = meta.get("transfer_dtype", self.transfer_dtype)
        if saved != self.transfer_dtype:
            raise ValueError(
                f"AOT artifact was compiled for transfer_dtype={saved!r}, "
                f"engine uses {self.transfer_dtype!r}")
        shape = tuple(meta.get("example_shape", self._example_input().shape))
        if self.device.type == "cuda":
            self._graphs(self._upload(self._plane(shape[0]))[None])
        self._aot_shape = shape

    def _plane(self, n: int) -> np.ndarray:
        """A synthetic flat-plane scan of n points."""
        rng = np.random.default_rng(0)
        pts = np.zeros((n, self.cfg.input_features), np.float32)
        pts[:, 0] = rng.uniform(self.cfg.pc_range[0], self.cfg.pc_range[3], n)
        pts[:, 1] = rng.uniform(self.cfg.pc_range[1], self.cfg.pc_range[4], n)
        pts[:, 2] = -self.cfg.lidar_height
        return pts

    def warmup(self, n: int | None = None) -> float:
        """Serve one synthetic flat-plane scan eagerly (the reference's
        `dryrun`, ros_node.py:73-95), which builds and loads the kernels;
        never through a captured graph.  Returns the seconds it took."""
        t0 = time.perf_counter()
        pts = self._plane(n or self.cfg.num_points)
        self._fetch(*self._read_back(len(pts), *self.run(self._upload(pts))))
        return time.perf_counter() - t0


class StreamingEngine:
    """Latest-value-mailbox streaming server around a GroundInferenceEngine.

    A daemon thread free-wheels on the newest submitted scan, dropping stale
    ones (reference InferenceThread, ros_node.py:51-138).  `submit` never
    blocks; `latest` returns the newest completed result (or None before the
    first inference finishes).  The hand-off is the native lock-free triple
    buffer (`native.NativeMailbox`; its memcpy runs outside the GIL) where
    the host library builds, else a locked slot; `use_native_mailbox=True`
    requires the native one, False the lock."""

    def __init__(self, engine: GroundInferenceEngine, warmup: bool = True,
                 use_native_mailbox: bool | None = None):
        self.engine = engine
        self._in_lock = threading.Lock()
        self._input = None
        self._input_seq = 0
        self._out_lock = threading.Lock()
        self._output = None
        self._event = threading.Event()
        self._running = False
        self._thread = None
        self.processed = 0
        self.errors = 0
        self.last_error = None
        self.compile_seconds = 0.0

        self._mailbox = None
        if use_native_mailbox is not False:
            if native.available():
                f = engine.cfg.input_features
                cap = (engine.cfg.num_points * 4 + engine.bucket) * f * 4
                self._mailbox = native.NativeMailbox(cap)
                self._mailbox_out = np.zeros(cap, np.uint8)
            elif use_native_mailbox:
                raise RuntimeError("use_native_mailbox=True, but the native "
                                   "host library is unavailable (no g++?)")
        if warmup:
            self.compile_seconds = engine.warmup()

    @property
    def native_mailbox(self) -> bool:
        """True while the hand-off is the native triple buffer."""
        return self._mailbox is not None

    def start(self):
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._running = False
        self._event.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._mailbox is not None:
            self._mailbox.close()
            self._mailbox = None

    def submit(self, points: np.ndarray) -> int:
        """Hand a new scan to the engine (non-blocking); returns its seq no."""
        if self._mailbox is not None:
            pts = np.ascontiguousarray(points, np.float32)
            header = np.asarray(pts.shape, np.int64)
            payload = np.concatenate(
                [header.view(np.uint8).reshape(-1),
                 pts.view(np.uint8).reshape(-1)])
            try:
                seq = self._mailbox.write(payload)
            except ValueError:
                seq = None  # oversized scan: fall through to the lock path
            if seq is not None:
                with self._in_lock:
                    self._input_seq = seq
                self._event.set()
                return seq
        with self._in_lock:
            self._input_seq += 1
            self._input = (self._input_seq, points)
        self._event.set()
        return self._input_seq

    def latest(self):
        """Newest completed (seq, elevation, labels) or None.

        May lag `submit` by one scan, as the reference reads possibly-stale
        output (ros_node.py:268-270)."""
        with self._out_lock:
            return self._output

    def _poll_input(self):
        """Newest unseen scan as (seq, points) or None."""
        if self._mailbox is not None:
            n, seq = self._mailbox.read_latest(self._mailbox_out)
            if n > 0:
                header = self._mailbox_out[:16].view(np.int64)
                pts = self._mailbox_out[16:n].view(np.float32).reshape(
                    int(header[0]), int(header[1])).copy()
                return seq, pts
        with self._in_lock:
            item, self._input = self._input, None
        return item

    def _loop(self):
        while self._running:
            self._event.wait(timeout=0.1)
            self._event.clear()
            try:
                item = self._poll_input()
                if item is None:
                    continue
                seq, points = item
                pred, labels = self.engine.infer(points)
            except Exception:   # keep serving (reference ros_node.py:116-120)
                self.errors += 1
                self.last_error = traceback.format_exc()
                continue
            with self._out_lock:
                self._output = (seq, pred, labels)
            self.processed += 1
