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
previous scans' compute.  Where the JAX engine dispatches one compiled XLA
executable a scan, the port launches each operation of `run` from Python;
`aot_load` captures `run` as one CUDA graph for the artifact's padded shape,
so a scan of that shape is one graph replay.
"""

from __future__ import annotations

import threading
import time
import traceback
from collections import deque

import numpy as np
import torch

from gndnet_tpu_torch import _ext, native
from gndnet_tpu_torch.config import GndNetConfig
from gndnet_tpu_torch.models.gndnet import GroundEstimatorNet
from gndnet_tpu_torch.ops.postproc import segment_cloud

_PAD_SENTINEL = 1e9  # pads bin far out of range -> seg label -1, no pillar
PIPELINE_DEPTH = 3   # infer_pipelined's default depth and the ring's slots
GRAPH_WARMUP = 3     # eager calls on a side stream before a capture


class _HostRing:
    """Pinned host buffers that feed the card from a copy stream.

    A slot is written again only after its last copy's event has
    completed; the device tensor a copy produces is handed to the caller's
    stream behind that event (and `record_stream`), so the caching
    allocator does not reuse it while the compute stream reads it."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.slots: list = []       # [pinned host tensor, copy event]
        self.next = 0
        self.lock = threading.Lock()
        self.reserve(slots)

    def reserve(self, slots: int) -> None:
        with self.lock:
            while len(self.slots) < slots:
                self.slots.append([None, None])

    def upload(self, padded: np.ndarray) -> torch.Tensor:
        src = torch.from_numpy(padded)
        with self.lock:
            slot = self.slots[self.next % len(self.slots)]
            self.next += 1
            host, done = slot
            if done is not None:
                done.synchronize()
            if host is None or host.shape != src.shape \
                    or host.dtype != src.dtype:
                host = torch.empty(src.shape, dtype=src.dtype,
                                   pin_memory=True)
            host.copy_(src)
            with torch.cuda.stream(self.stream):
                dev = host.to(self.device, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self.stream)
            slot[:] = host, done
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(done)
        dev.record_stream(compute)
        return dev


class _ScanGraph:
    """One CUDA graph of the engine's `run` for one padded input shape.

    Captured after GRAPH_WARMUP eager calls on a side stream (they load
    every kernel and take each one's first-launch set-up out of the
    capture).  Each call fills the static input by a stream-ordered copy,
    replays, and copies the static outputs out; a lock keeps fill, replay
    and copy-out together, and the next fill waits on the last copy-out's
    event, since the streaming thread and the caller may both serve.  The
    serving path launches K1-K3 ('affine') or K7 ('sorted') and no K8 or
    K9, whose wrappers take a host-side epoch a call that a replay would
    repeat; a graph of a path that launched them would be wrong."""

    def __init__(self, run, example: torch.Tensor):
        dev = example.device
        self.input = example.clone()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(GRAPH_WARMUP):
                run(self.input)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: another thread's CUDA work does not void the capture
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.pred, self.labels = run(self.input)
        self.done = torch.cuda.Event()
        self.done.record()
        self.lock = threading.Lock()
        self.replays = 0

    def __call__(self, padded: torch.Tensor):
        with self.lock:
            stream = torch.cuda.current_stream(padded.device)
            stream.wait_event(self.done)
            self.input.copy_(padded, non_blocking=True)
            self.graph.replay()
            out = self.pred.clone(), self.labels.clone()
            self.done.record(stream)
            self.replays += 1
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
        # the CPU engine copies nothing: no pinned memory, no stream
        self._ring = (_HostRing(self.device, PIPELINE_DEPTH)
                      if self.device.type == "cuda" else None)
        self._graph = None      # (padded shape, _ScanGraph or None)

    def _pad(self, points: np.ndarray) -> np.ndarray:
        n = points.shape[0]
        target = max(self.bucket, -(-n // self.bucket) * self.bucket)
        if n != target:
            pad = np.full((target - n, points.shape[1]), _PAD_SENTINEL,
                          points.dtype)
            points = np.concatenate([points, pad])
        if self.transfer_dtype == "int16":
            points = np.clip(np.rint(points / self.QUANT_SCALE),
                             -32768, 32767).astype(np.int16)
        return points

    def _prepare(self, points: np.ndarray) -> tuple:
        points = np.asarray(points, np.float32)
        k = self.transfer_features
        if points.shape[1] < k:
            points = np.concatenate(
                [points, np.zeros((points.shape[0], k - points.shape[1]),
                                  np.float32)], axis=1)
        return self._pad(points[:, :k]), points.shape[0]

    def transfer_bytes(self, n_points: int) -> int:
        """Host->device bytes one scan of n_points costs through this
        engine's transfer configuration (after bucket padding)."""
        padded = max(self.bucket, -(-n_points // self.bucket) * self.bucket)
        item = 2 if self.transfer_dtype == "int16" else 4
        return padded * self.transfer_features * item

    def _upload(self, padded: np.ndarray) -> torch.Tensor:
        """A prepared scan on the engine's device, ready on the current
        stream."""
        if self._ring is None:
            return torch.from_numpy(padded)
        return self._ring.upload(padded)

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
        pts = self.device_points(padded)
        pred = self.model.fused(pts, reference=reference)
        labels = segment_cloud(pts, self.cfg.grid_range,
                               self.cfg.voxel_size[0], pred.transpose(1, 2),
                               self.threshold)
        return pred, labels.to(torch.int8)

    def _dispatch(self, padded: torch.Tensor):
        """`run`, or the replay of the graph `aot_load` captured when the
        padded shape is the one it was captured for."""
        if self._graph is not None:
            shape, graph = self._graph
            if graph is not None and tuple(padded.shape) == shape:
                return graph(padded)
        return self.run(padded)

    def infer_async(self, points: np.ndarray) -> tuple:
        """Non-blocking submit: returns (n, pred_dev, labels_dev), device
        tensors on the current stream, without waiting for the card.
        Interleave several calls before materialising to overlap the
        host-to-device copies with compute."""
        padded, n = self._prepare(points)
        pred, labels = self._dispatch(self._upload(padded))
        return n, pred, labels

    @staticmethod
    def _fetch(n: int, pred: torch.Tensor, labels: torch.Tensor) -> tuple:
        return pred.cpu().numpy(), labels[:n].cpu().numpy()

    def infer(self, points: np.ndarray) -> tuple:
        """points: (N, >=3) float32 (extra columns beyond
        cfg.input_features are ignored, missing ones zero-filled).
        Returns (elevation (ny, nx) np.float32, labels (N,) np.int8 with
        values {1: obstacle, 0: ground, -1: out of grid})."""
        return self._fetch(*self.infer_async(points))

    def infer_pipelined(self, scans, depth: int = PIPELINE_DEPTH):
        """Generator yielding (elevation, labels) per scan, in submission
        order, with `depth` scans in flight, so the copies overlap compute
        across scans (sustained-throughput serving)."""
        if depth < 1:
            raise ValueError(f"depth must be at least 1, got {depth}")
        if self._ring is not None:
            self._ring.reserve(depth)
        inflight = deque()
        for scan in scans:
            inflight.append(self.infer_async(scan))
            if len(inflight) >= depth:
                yield self._fetch(*inflight.popleft())
        while inflight:
            yield self._fetch(*inflight.popleft())

    def infer_many(self, scans) -> list:
        """Batched inference of a burst of scans in one device call: all
        scans must fall into one padded bucket.  Returns [(elevation
        (ny, nx) np.float32, labels (N_i,) np.int8), ...] in submission
        order."""
        prepared = [self._prepare(s) for s in scans]
        shapes = {p.shape for p, _ in prepared}
        if len(shapes) != 1:
            raise ValueError(f"scans fall into mixed buckets {shapes}; "
                             "pad or split the burst")
        preds, labels = self.run_many(
            torch.from_numpy(np.stack([p for p, _ in prepared])))
        preds, labels = preds.cpu().numpy(), labels.cpu().numpy()
        return [(preds[i], labels[i][:n])
                for i, (_, n) in enumerate(prepared)]

    def _example_input(self, n: int | None = None) -> np.ndarray:
        """A padded input of the shape the engine serves."""
        n = n or self.cfg.num_points
        pts = np.zeros((n, self.transfer_features), np.float32)
        return self._pad(pts)

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
        """Serve from an `aot_save` artifact: on a CUDA engine, capture one
        CUDA graph of `run` for the padded shape the artifact records (it
        may differ from the default); scans of that shape replay it, any
        other shape runs `run` eagerly.  Raises ValueError if the artifact
        does not fit this engine or process, and whatever the capture
        raises: a CUDA engine never serves eagerly in its stead.  A CPU
        engine checks the artifact and serves eagerly."""
        from gndnet_tpu_torch.utils.compile_cache import load_compiled

        meta = load_compiled(path, self.device)
        saved = meta.get("transfer_dtype", self.transfer_dtype)
        if saved != self.transfer_dtype:
            raise ValueError(
                f"AOT artifact was compiled for transfer_dtype={saved!r}, "
                f"engine uses {self.transfer_dtype!r}")
        shape = tuple(meta.get("example_shape", self._example_input().shape))
        self._graph = (shape, self._capture(shape))

    def _capture(self, shape: tuple):
        """The graph of `run` for `shape` on a CUDA engine; None on the
        CPU, which has no graphs."""
        if self.device.type != "cuda":
            return None
        padded, _ = self._prepare(self._plane(shape[0]))
        return _ScanGraph(self.run, self._upload(padded))

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
        padded, m = self._prepare(self._plane(n or self.cfg.num_points))
        self._fetch(m, *self.run(self._upload(padded)))
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
