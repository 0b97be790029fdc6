"""Logging and metric utilities: counterparts of `gndnet_tpu.utils.logging`.

* `setup_logger`: the reference's timestamped file+console format
  (training.py:44-53); `AverageMeter` (training.py:320-335).
* Streaming accumulators subsuming torchplus.metrics (reference
  torchplus/metrics.py:7-281): `Scalar`, `Accuracy`, `PrecisionRecall`.
* `create_run_dir`; `parse_log_file` and `plot_epoch_losses`, the offline
  log analytics of the reference's regex parser (scripts/log_parser.py:
  14-87), reading the `training.log` that `train.train_and_evaluate`
  writes.  matplotlib is imported only by the plot.
"""

from __future__ import annotations

import datetime
import logging
import os
import re
from collections import defaultdict

import numpy as np


def setup_logger(name: str = "main", log_file: str | None = None,
                 level=logging.DEBUG) -> logging.Logger:
    formatter = logging.Formatter(
        "%(asctime)s | %(levelname)s | %(name)s | %(message)s")
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.propagate = False   # no duplicate lines through the root logger
    if not any(isinstance(h, logging.StreamHandler) for h in logger.handlers):
        sh = logging.StreamHandler()
        sh.setFormatter(formatter)
        logger.addHandler(sh)
    if log_file and not any(
            isinstance(h, logging.FileHandler)
            and getattr(h, "baseFilename", None) == log_file
            for h in logger.handlers):
        fh = logging.FileHandler(log_file)
        fh.setLevel(level)
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    return logger


class AverageMeter:
    """Running value / average tracker."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


class Scalar:
    """Streaming scalar mean (torchplus.metrics.Scalar)."""

    def __init__(self):
        self.total = 0.0
        self.count = 0

    def update(self, value, n: int = 1):
        self.total += float(value) * n
        self.count += n

    @property
    def value(self):
        return self.total / max(self.count, 1)

    def clear(self):
        self.total, self.count = 0.0, 0


class Accuracy:
    """Streaming classification accuracy (torchplus.metrics.Accuracy)."""

    def __init__(self):
        self.correct = 0
        self.total = 0

    def update(self, pred, target):
        pred, target = np.asarray(pred), np.asarray(target)
        self.correct += int(np.sum(pred == target))
        self.total += int(pred.size)

    @property
    def value(self):
        return self.correct / max(self.total, 1)

    def clear(self):
        self.correct = self.total = 0


class PrecisionRecall:
    """Streaming binary precision / recall / IoU from per-frame masks
    (torchplus.metrics.Precision / Recall; the accumulator of reference
    evaluate_SemanticKITTI.py:199-208)."""

    def __init__(self):
        self.tp = self.fp = self.fn = 0

    def update(self, pred, target):
        pred = np.asarray(pred).astype(bool)
        target = np.asarray(target).astype(bool)
        self.tp += int(np.sum(pred & target))
        self.fp += int(np.sum(pred & ~target))
        self.fn += int(np.sum(~pred & target))

    @property
    def precision(self):
        return self.tp / max(self.tp + self.fp, 1)

    @property
    def recall(self):
        return self.tp / max(self.tp + self.fn, 1)

    @property
    def iou(self):
        return self.tp / max(self.tp + self.fp + self.fn, 1)


def create_run_dir(root: str, prefix: str = "run") -> str:
    """Create and return a timestamped run directory (torchplus/train/
    common.py:5-23)."""
    stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    path = os.path.join(root, f"{prefix}-{stamp}")
    os.makedirs(path, exist_ok=True)
    return path


_EPOCH_RE = re.compile(
    r"Epoch:\s*\[(\d+)\]\[(\d+)/(\d+)\].*?Loss\s+([\d.eE+-]+)\s+"
    r"\(([\d.eE+-]+)\)")
_VALID_RE = re.compile(
    r"Test:\s*\[(\d+)/(\d+)\].*?Loss\s+([\d.eE+-]+)\s+\(([\d.eE+-]+)\)")


def parse_log_file(path: str) -> dict:
    """Per-epoch train and validation losses from a training log's
    progress lines: {'epochs', 'train_loss' (each epoch's mean of its
    logged step losses), 'valid_loss' (the running average of every
    logged validation line)}."""
    train = defaultdict(list)
    valid = []
    with open(path) as f:
        for line in f:
            m = _EPOCH_RE.search(line)
            if m:
                train[int(m.group(1))].append(float(m.group(4)))
                continue
            m = _VALID_RE.search(line)
            if m:
                valid.append(float(m.group(4)))
    epochs = sorted(train)
    return {"epochs": epochs,
            "train_loss": [sum(train[e]) / len(train[e]) for e in epochs],
            "valid_loss": valid}


def plot_epoch_losses(parsed: dict, out_path: str) -> None:
    """Loss curves of `parse_log_file`'s result as a PNG (reference
    scripts/log_parser.py:66-87)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    ax.plot(parsed["epochs"], parsed["train_loss"], label="train")
    if parsed["valid_loss"]:
        ax.plot(parsed["epochs"][:len(parsed["valid_loss"])],
                parsed["valid_loss"][:len(parsed["epochs"])],
                label="valid")
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.legend()
    fig.savefig(out_path)
    plt.close(fig)
