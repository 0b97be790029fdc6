"""Checkpoints as the reference writes them: one `torch.save` dict per run
directory, `checkpoint.pth.tar`, with a `model_best.pth.tar` copy
(reference training.py:296-316), restored by `--resume`.

The dict holds the reference's keys, `state_dict` (the reference's
parameter names), `epoch` and `lowest_loss`, so
`gndnet_tpu.checkpoint.load_torch_checkpoint` reads it, plus `optimizer`
(the SGD momentum buffers and the step count that sets the schedule), so
a resumed run continues where it stopped.  Counterpart of the JAX package's
orbax `CheckpointManager` for single-device runs.  `load_torch_checkpoint`
reads such a file, or the reference's own, for serving.
"""

from __future__ import annotations

import os
import shutil

import torch

CHECKPOINT = "checkpoint.pth.tar"
BEST = "model_best.pth.tar"


def save_checkpoint(directory: str, state, epoch: int, lowest_loss: float,
                    is_best: bool = False) -> str:
    """Write `state` (a `train.TrainState`) after `epoch` epochs; copy it
    to model_best when `is_best`.  Returns the checkpoint's path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, CHECKPOINT)
    tmp = path + ".tmp"
    torch.save({
        "epoch": epoch,
        "state_dict": {k: v.detach().cpu()
                       for k, v in state.model.state_dict().items()},
        "lowest_loss": float(lowest_loss),
        "optimizer": state.tx.state_dict(),
    }, tmp)
    os.replace(tmp, path)   # never a torn checkpoint
    if is_best:
        shutil.copyfile(path, os.path.join(directory, BEST))
    return path


def latest_checkpoint(directory: str) -> str | None:
    path = os.path.join(directory, CHECKPOINT)
    return path if os.path.exists(path) else None


def load_torch_checkpoint(path: str, cfg=None) -> dict:
    """Read a reference `.pth.tar` (a dict with a `state_dict` key, or a
    bare state dict) for serving.

    Returns {'state_dict', 'epoch', 'lowest_loss'}, the reference's saved
    dict (training.py:300-305).  The port's modules use the reference's
    parameter names, so `load_state_dict` (or `GroundInferenceEngine`)
    takes the state dict unchanged; `cfg` is accepted for the JAX loader's
    signature and not needed."""
    del cfg
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state_dict = ckpt["state_dict"] if "state_dict" in ckpt else ckpt
    return {"state_dict": {k: torch.as_tensor(v)
                           for k, v in state_dict.items()},
            "epoch": ckpt.get("epoch", 0),
            "lowest_loss": ckpt.get("lowest_loss", float("inf"))}


def restore_checkpoint(path: str, state) -> dict:
    """Load a checkpoint into `state` in place: weights, batch-norm
    statistics, momentum buffers and step count.  Returns {'epoch',
    'lowest_loss'}."""
    ckpt = torch.load(path, map_location=state.model.device,
                      weights_only=False)
    state.model.load_state_dict(ckpt["state_dict"])
    state.tx.load_state_dict(ckpt["optimizer"])
    return {"epoch": int(ckpt["epoch"]),
            "lowest_loss": float(ckpt["lowest_loss"])}
