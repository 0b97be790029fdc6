"""Logging utilities: counterparts of `gndnet_tpu.utils.logging`'s
`setup_logger` (the reference's timestamped file+console format,
training.py:44-53) and `AverageMeter` (training.py:320-335)."""

from __future__ import annotations

import logging


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
