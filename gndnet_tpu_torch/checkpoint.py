"""Checkpoints in the reference's torch format, and their manager.

Every file is one `torch.save` of the reference's dict (training.py:
300-305): `state_dict` (the reference's parameter names), `epoch` and
`lowest_loss`, so `gndnet_tpu.checkpoint.load_torch_checkpoint` reads it,
plus `optimizer` (the SGD momentum buffers, the schedule's step count, the
train step count and the loss scale), so a resumed run continues where it
stopped.

`CheckpointManager` is the counterpart of the JAX package's orbax manager
(`gndnet_tpu.checkpoint.CheckpointManager`: latest and best retention,
`max_to_keep` garbage collection, writes that are atomic and hold off
SIGINT).  Its directory holds:

    checkpoint_<step>.pth.tar   the last `max_to_keep` saved steps
    checkpoint.pth.tar          a copy of the latest (the reference's name)
    model_best.pth.tar          a copy of the best (the reference's name)

`load_torch_checkpoint` reads such a file, or the reference's own, for
serving.
"""

from __future__ import annotations

import contextlib
import os
import re
import shutil
import signal
import threading

import torch

CHECKPOINT = "checkpoint.pth.tar"
BEST = "model_best.pth.tar"
_STEP_FILE = re.compile(r"^checkpoint_(\d+)\.pth\.tar$")


def checkpoint_dict(state, epoch: int, lowest_loss: float) -> dict:
    """The reference's dict for `state` (a `train.TrainState`) after
    `epoch` epochs, its tensors on the host."""
    return {"epoch": int(epoch),
            "state_dict": {k: v.detach().cpu()
                           for k, v in state.model.state_dict().items()},
            "lowest_loss": float(lowest_loss),
            "optimizer": state.state_dict()}


@contextlib.contextmanager
def _defer_sigint():
    """Hold Ctrl-C until the block ends, so no write is torn (the
    torchplus manager's SIGINT-safe saves, reference torchplus/train/
    checkpoint.py:62-113).  Only the main thread may set handlers."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    pending = []
    old = signal.signal(signal.SIGINT, lambda s, f: pending.append(s))
    try:
        yield
    finally:
        signal.signal(signal.SIGINT, old)
        if pending:
            os.kill(os.getpid(), signal.SIGINT)


def _atomic_save(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _atomic_copy(src: str, dst: str) -> None:
    tmp = dst + ".tmp"
    shutil.copyfile(src, tmp)
    os.replace(tmp, dst)


class CheckpointManager:
    """Latest and best checkpoints with `max_to_keep` garbage collection,
    in one directory of torch files (see the module docstring)."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"checkpoint_{step}.pth.tar")

    def steps(self) -> list:
        """The saved steps, ascending."""
        return sorted(int(m.group(1)) for m in map(
            _STEP_FILE.match, os.listdir(self.directory)) if m)

    def save(self, step: int, state: dict, is_best: bool = False) -> None:
        """Write `state`, the reference's dict (`checkpoint_dict`), as
        `step`; refresh the latest copy, and the best one when `is_best`;
        then drop the oldest steps past `max_to_keep`."""
        with _defer_sigint():
            path = self.path(step)
            _atomic_save(state, path)
            _atomic_copy(path, os.path.join(self.directory, CHECKPOINT))
            if is_best:
                _atomic_copy(path, os.path.join(self.directory, BEST))
            for old in self.steps()[:-self.max_to_keep]:
                os.remove(self.path(old))

    def latest_step(self):
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None):
        """The dict saved as `step` (default the latest); None if there is
        none."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        return _load(self.path(step))

    def restore_best(self):
        path = os.path.join(self.directory, BEST)
        return _load(path) if os.path.exists(path) else None

    def close(self) -> None:
        """Nothing is held open: each save is complete when it returns."""


def _load(path: str, device="cpu") -> dict:
    return torch.load(path, map_location=device, weights_only=False)


def load_torch_checkpoint(path: str, cfg=None) -> dict:
    """Read a reference `.pth.tar` (a dict with a `state_dict` key, or a
    bare state dict) for serving.

    Returns {'state_dict', 'epoch', 'lowest_loss'}, the reference's saved
    dict (training.py:300-305).  The port's modules use the reference's
    parameter names, so `load_state_dict` (or `GroundInferenceEngine`)
    takes the state dict unchanged; `cfg` is accepted for the JAX loader's
    signature and not needed."""
    del cfg
    ckpt = _load(path)
    state_dict = ckpt["state_dict"] if "state_dict" in ckpt else ckpt
    return {"state_dict": {k: torch.as_tensor(v)
                           for k, v in state_dict.items()},
            "epoch": ckpt.get("epoch", 0),
            "lowest_loss": ckpt.get("lowest_loss", float("inf"))}


def load_weights(path: str, cfg=None) -> dict:
    """The state dict of a `.pth.tar` / `.pth` file or of the latest step
    in a `CheckpointManager` directory."""
    if os.path.isdir(path):
        restored = CheckpointManager(path).restore()
        if restored is None:
            raise FileNotFoundError(f"no checkpoint found in {path}")
        return {k: torch.as_tensor(v)
                for k, v in restored["state_dict"].items()}
    return load_torch_checkpoint(path, cfg)["state_dict"]


def restore_checkpoint(ckpt, state) -> dict:
    """Load a checkpoint (a path, or a dict `CheckpointManager.restore`
    returned) into `state` in place: weights, batch-norm statistics,
    momentum buffers, step counts and loss scale.  Returns {'epoch',
    'lowest_loss'}."""
    if isinstance(ckpt, (str, os.PathLike)):
        ckpt = _load(ckpt, state.model.device)
    state.model.load_state_dict(ckpt["state_dict"])
    state.load_state_dict(ckpt["optimizer"])
    return {"epoch": int(ckpt["epoch"]),
            "lowest_loss": float(ckpt["lowest_loss"])}
