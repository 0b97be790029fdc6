"""Where the time of one kitti_sem train step goes, on the card.

    python -m gndnet_tpu_torch.profile_train [--batch 2 16] [--steps 10]
                                             [--out FILE]

Trains on synthetic labelled 100 000-point scans (`synthetic_labelled_batch`)
at the flagship training settings (bf16 convs, 'default' precision, the
affine canvas, random weights from a seed) and prints, for each batch size,
one JSON line:
  * the train step as it runs on the card, one CUDA graph replay a step:
    host-clock ms a step (and steps/s, scans/s), `kernels`
    (`profile_serve.kernel_times` of whole steps: device time per kernel
    name, device operations per step and the device busy share), peak
    device memory, `replays` and `eager_steps` (the warm-up and capture);
  * `eager`: the same for `make_train_step(eager=True)`;
  * `stages_ms`: mean milliseconds per step of each stage of an eager
    step, by CUDA events in one stream: canvas forward (binning, sort, K3,
    K5, epilogue), SegNet forward with batch statistics, loss, backward
    (K6 and the convs' gradients), optimizer step; `stages_host_ms`: the
    host-clock time to issue each;
  * `optimizer`: `kernel_times` of the eager optimizer update alone, and
    `torch_sgd` of torch's SGD (foreach) on copies of the same parameters
    and gradients: the host time of each update beside the other's.
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


def stage_times(cfg, state, points, labels, steps: int) -> tuple:
    """Mean ms per step of each stage over `steps` steps after a warm one:
    on the device, by CUDA events between stages, and on the host clock,
    the time to issue it (no sync inside a step)."""
    model = state.model
    loss_fn = train.loss_fn(cfg)
    device = dict.fromkeys(STAGES, 0.0)
    host = dict.fromkeys(STAGES, 0.0)
    for step in range(steps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        t = [time.perf_counter()]
        ev[0].record()
        canvas = model.canvas(points)
        ev[1].record()
        t.append(time.perf_counter())
        pred = model.encoder_decoder(canvas, train=True)[..., 0]
        ev[2].record()
        t.append(time.perf_counter())
        loss = loss_fn(pred, labels)
        ev[3].record()
        t.append(time.perf_counter())
        state.tx.zero_grad()
        loss.backward()
        ev[4].record()
        t.append(time.perf_counter())
        state.tx.step()
        ev[5].record()
        t.append(time.perf_counter())
        torch.cuda.synchronize()
        if step == 0:           # warms up, untimed
            continue
        for i, name in enumerate(STAGES):
            device[name] += ev[i].elapsed_time(ev[i + 1])
            host[name] += (t[i + 1] - t[i]) * 1e3
    return ({k: v / steps for k, v in device.items()},
            {k: v / steps for k, v in host.items()})


def timed(cfg, batch: int, steps: int, points, labels, eager: bool) -> dict:
    """Host-clock ms a step, `kernel_times` of whole steps and peak device
    memory of the train step from a fresh state: replayed as its CUDA
    graph, or with `eager=True`; two warm steps first (the graph's capture
    in the first)."""
    state = train.create_train_state(cfg, 100,
                                     state_dict=init_state_dict(cfg, 0))
    step = train.make_train_step(cfg, eager=eager)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        step(state, points, labels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step(state, points, labels)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    return {"step_ms_host_clock": step_ms,
            "steps_per_s_host_clock": 1e3 / step_ms,
            "scans_per_s_host_clock": batch * 1e3 / step_ms,
            "kernels": kernel_times(lambda: step(state, points, labels),
                                    steps),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
            "replays": step.replays, "eager_steps": step.eager_steps}


def profile_batch(cfg, batch: int, steps: int, rng) -> dict:
    """The graph step's numbers, the eager step's under `eager`, and the
    stages of an eager step."""
    points, labels = (torch.from_numpy(x).cuda() for x in
                      synthetic_labelled_batch(cfg, rng, batch,
                                               cfg.num_points))
    graph = timed(cfg, batch, steps, points, labels, eager=False)
    eager = timed(cfg, batch, steps, points, labels, eager=True)
    state = train.create_train_state(cfg, 100,
                                     state_dict=init_state_dict(cfg, 0))
    device, host = stage_times(cfg, state, points, labels, steps)
    # torch's SGD (foreach) on copies of the parameters and gradients
    params = [p.detach().clone().requires_grad_() for p in state.tx.params]
    for p, q in zip(params, state.tx.params):
        p.grad = None if q.grad is None else q.grad.clone()
    sgd = torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum,
                          weight_decay=cfg.weight_decay, foreach=True)
    return {"batch": batch, "steps": steps, **graph, "eager": eager,
            "stages_ms": device, "stages_host_ms": host,
            "optimizer": kernel_times(state.tx.step, steps),
            "torch_sgd": kernel_times(sgd.step, steps)}


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
