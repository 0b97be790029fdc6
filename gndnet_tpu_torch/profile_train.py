"""Where the time of one kitti_sem train step goes, on the card.

    python -m gndnet_tpu_torch.profile_train [--batch 2 16] [--steps 10]
                                             [--out FILE]

Trains on synthetic labelled 100 000-point scans (`synthetic_labelled_batch`)
at the flagship training settings (bf16 convs, 'default' precision, the
affine canvas, random weights from a seed) and prints, for each batch size,
JSON lines:
  * `stages`: mean milliseconds per step of each stage, by CUDA events in
    one stream: canvas forward (binning, sort, K3, K5, epilogue), SegNet
    forward with batch statistics, loss, backward (K6 and the convs'
    gradients), optimizer step; plus the host-clock step time;
  * `kernels`: `profile_serve.kernel_times` of whole steps: device time per
    kernel name, device operations per step and the device busy share.
Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from gndnet_tpu_torch import train
from gndnet_tpu_torch.config import kitti_sem_config
from gndnet_tpu_torch.profile_serve import card, kernel_times, write_lines
from gndnet_tpu_torch.synthetic import synthetic_labelled_batch
from gndnet_tpu_torch.weights import init_state_dict

STAGES = ("canvas", "segnet", "loss", "backward", "optimizer")


def stage_times(cfg, state, points, labels, steps: int) -> dict:
    """Mean ms per step of each stage, CUDA events between stages."""
    model = state.model
    loss_fn = train.loss_fn(cfg)
    totals = dict.fromkeys(STAGES, 0.0)
    for _ in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        canvas = model.canvas(points)
        ev[1].record()
        pred = model.encoder_decoder(canvas, train=True)[..., 0]
        ev[2].record()
        loss = loss_fn(pred, labels)
        ev[3].record()
        state.tx.zero_grad()
        loss.backward()
        ev[4].record()
        state.tx.step()
        ev[5].record()
        torch.cuda.synchronize()
        for i, name in enumerate(STAGES):
            totals[name] += ev[i].elapsed_time(ev[i + 1])
    return {k: v / steps for k, v in totals.items()}


def profile_batch(cfg, batch: int, steps: int, rng) -> dict:
    state = train.create_train_state(cfg, 100,
                                     state_dict=init_state_dict(cfg, 0))
    step = train.make_train_step(cfg)
    points, labels = (torch.from_numpy(x).cuda() for x in
                      synthetic_labelled_batch(cfg, rng, batch,
                                               cfg.num_points))
    for _ in range(2):                                  # warm: cuDNN plans
        step(state, points, labels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step(state, points, labels)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    return {"batch": batch, "steps": steps,
            "stages_ms": stage_times(cfg, state, points, labels, steps),
            "step_ms_host_clock": step_ms,
            "steps_per_s_host_clock": 1e3 / step_ms,
            "scans_per_s_host_clock": batch * 1e3 / step_ms,
            "kernels": kernel_times(lambda: step(state, points, labels),
                                    steps)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[2, 16])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default=None,
                    help="also write the JSON lines to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    cfg = kitti_sem_config().replace(
        compute_dtype="bfloat16", matmul_precision="default",
        fused_impl="affine")
    rng = np.random.default_rng(0)
    lines = [{"card": card(), "torch": torch.__version__}]
    lines += [profile_batch(cfg, b, args.steps, rng) for b in args.batch]
    write_lines(lines, args.out)


if __name__ == "__main__":
    main()
