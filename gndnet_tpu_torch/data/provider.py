"""Dataset provider: counterparts of `gndnet_tpu.data.provider`'s
`index_frames`, `GroundDataset` and `iterate_batches` (the reference's
kitti_gnd_sync loader and DataLoader arguments), `StreamingLoader` (a
background thread streaming batches from disk), and of its device prefetch
as pinned host memory plus a non-blocking copy."""

from __future__ import annotations

import collections
import logging
import os
import queue
import threading
from typing import Iterator

import numpy as np
import torch


def index_frames(data_dir: str, split: str, skip_frames: int = 1):
    """List (cloud_path, label_path) pairs under data_dir/split/<seq>/."""
    root = os.path.join(data_dir, split)
    pairs = []
    for seq in sorted(os.listdir(root)):
        velo_dir = os.path.join(root, seq, "reduced_velo")
        label_dir = os.path.join(root, seq, "gnd_labels")
        if not os.path.isdir(velo_dir):
            continue
        files = sorted(os.listdir(velo_dir))
        for i in range(0, len(files), skip_frames):
            pairs.append((os.path.join(velo_dir, files[i]),
                          os.path.join(label_dir, files[i])))
    return pairs


class GroundDataset:
    """Eager in-RAM (clouds, labels) arrays with a byte budget."""

    def __init__(self, data_dir: str, split: str = "training",
                 skip_frames: int = 1, num_input_features: int = 3,
                 max_memory: float = 4e9,
                 logger: logging.Logger = logging.root):
        self.num_input_features = num_input_features
        pairs = index_frames(data_dir, split, skip_frames)
        if not pairs:
            raise FileNotFoundError(
                f"no frames under {data_dir}/{split}/<seq>/reduced_velo")
        clouds, labels, used = [], [], 0
        for cpath, lpath in pairs:
            cloud = np.load(cpath)[:, :num_input_features].astype(np.float32)
            label = np.load(lpath).astype(np.float32)
            need = cloud.nbytes + label.nbytes
            if used + need > max_memory:
                logger.warning(
                    "GroundDataset: stopping at %d/%d frames (%.1f MiB "
                    "budget)", len(clouds), len(pairs), max_memory / 2**20)
                break
            clouds.append(cloud)
            labels.append(label)
            used += need
        self.data = np.stack(clouds)
        self.labels = np.stack(labels)
        logger.info("GroundDataset[%s]: %d frames, %.1f MiB",
                    split, len(self.data), used / 2**20)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return self.data[i], self.labels[i]


def iterate_batches(dataset, batch_size: int, shuffle: bool = True,
                    drop_last: bool = True, seed: int = 0,
                    epoch: int = 0) -> Iterator[tuple]:
    """Yield (clouds (B, P, F), labels (B, H, W)) numpy batches, in the
    same order as the JAX package for the same seed and epoch."""
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(order)
    stop = n - (n % batch_size) if drop_last else n
    for s in range(0, stop, batch_size):
        idx = order[s:s + batch_size]
        yield dataset.data[idx], dataset.labels[idx]


class StreamingLoader:
    """Background-thread disk streaming with a bounded prefetch queue.

    Streams batches without holding the dataset in RAM; each epoch
    reshuffles the frame index from `seed + epoch`.  The working form of
    the reference's SharedMemory AsyncDataLoader
    (dataset_provider.py:26-127, whose label map aliases the data buffer,
    a bug not reproduced)."""

    def __init__(self, data_dir: str, split: str, batch_size: int,
                 skip_frames: int = 1, num_input_features: int = 3,
                 queue_depth: int = 4, seed: int = 0, drop_last: bool = True):
        self.pairs = index_frames(data_dir, split, skip_frames)
        if not self.pairs:
            raise FileNotFoundError(f"no frames under {data_dir}/{split}")
        self.batch_size = batch_size
        self.num_input_features = num_input_features
        self.queue_depth = queue_depth
        self.seed = seed
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.pairs)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def epoch(self, epoch: int = 0) -> Iterator[tuple]:
        """Yield (clouds (B, P, F), labels (B, H, W)) float32 numpy
        batches, read by a daemon thread at most `queue_depth` ahead.  A
        consumer that stops early (closes or drops the generator) stops
        the thread too, even while it waits on a full queue."""
        order = np.arange(len(self.pairs))
        np.random.default_rng(self.seed + epoch).shuffle(order)
        stop = (len(order) - (len(order) % self.batch_size)
                if self.drop_last else len(order))
        q: queue.Queue = queue.Queue(maxsize=self.queue_depth)
        stop_flag = threading.Event()

        def put(item) -> bool:
            while not stop_flag.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for s in range(0, stop, self.batch_size):
                    idx = order[s:s + self.batch_size]
                    clouds = np.stack([
                        np.load(self.pairs[i][0])[:, :self.num_input_features]
                        .astype(np.float32) for i in idx])
                    labels = np.stack([
                        np.load(self.pairs[i][1]).astype(np.float32)
                        for i in idx])
                    if not put((clouds, labels)):
                        return
            finally:
                put(None)

        threading.Thread(target=worker, daemon=True,
                         name="StreamingLoader").start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                yield item
        finally:
            stop_flag.set()


def _to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def prefetch_to_device(iterator: Iterator, device, size: int = 2
                       ) -> Iterator:
    """Keep `size` batches in flight to `device` ahead of the consumer:
    each array goes through pinned host memory and a non-blocking copy on
    the current stream, so the copy overlaps the previous step."""
    device = torch.device(device)
    buf: collections.deque = collections.deque()
    for item in iterator:
        buf.append(tuple(_to_device(x, device) for x in item))
        if len(buf) >= size:
            yield buf.popleft()
    while buf:
        yield buf.popleft()
