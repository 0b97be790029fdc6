"""Whether the use_norm train step repeats itself on the card, and how far
the fused step lands from the pillar-path step (chip_smoke's phase-25
invariant, after tests/test_train.py:196-215).

    python -m gndnet_tpu_torch.profile_use_norm [--seed 7] [--batches 6]
                                                [--witness K ...]

kitti_sem as shipped with use_norm on, random weights from seed 0, B=2
synthetic labelled 100 000-point scans (`synthetic_labelled_batch`).  For
each batch it takes one step of each path from the same weights, twice,
and prints one JSON line:
  * `loss_rel`: |fused - pillar| / |pillar| of the first pair's losses;
  * `nearest_bound`: the three parameters nearest the invariant's bound,
    max over elements of |fused - pillar| / (1e-5 + 1e-3 |pillar|) (1 is
    the bound), first pair; `second_pair`: the largest such value of the
    second pair;
  * `repeat_max_abs`: per path, the largest change of a parameter between
    its two steps;
  * for a batch named by `--witness`, `witness`: each path's step also on
    the CPU (float32, every kernel's plain version and stream-order sums:
    the port's CPU steps, which the tests hold against the JAX package's),
    the four losses, and the largest share of the bound and the
    parameters beyond it for each pair of steps.
Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from gndnet_tpu_torch import train
from gndnet_tpu_torch.config import kitti_sem_config
from gndnet_tpu_torch.profile_serve import card
from gndnet_tpu_torch.synthetic import synthetic_labelled_batch
from gndnet_tpu_torch.weights import init_state_dict

RTOL, ATOL = 1e-3, 1e-5      # chip_smoke's PILLAR_STEP_RTOL and atol


def step(cfg, sd, points, labels, pillar: bool, device="cuda"):
    state = train.create_train_state(cfg, 100, state_dict=sd, device=device)
    state, loss = train.make_train_step(cfg, use_pillar_path=pillar,
                                        eager=True)(
        state, points.to(device), labels.to(device))
    return ({k: v.detach().clone()
             for k, v in state.model.named_parameters()}, float(loss))


def share_of_bound(fused: dict, pillar: dict) -> dict:
    return {n: float(((fused[n] - pillar[n]).abs()
                      / (ATOL + RTOL * pillar[n].abs())).max())
            for n in pillar}


def witness(cfg, sd, points, labels, card_steps) -> dict:
    """The card's steps (pillar, fused) against the same steps on the
    CPU: losses and, per pair, the largest share of the bound and the
    parameters past it."""
    (pc, lpc), (fc, lfc) = card_steps
    (pp, lpp), (fp, lfp) = (step(cfg, sd, points, labels, pillar, "cpu")
                            for pillar in (True, False))
    cpu = [{n: v.cpu() for n, v in ps.items()} for ps in (pc, fc)]
    pairs = {"card_fused_vs_card_pillar": (fc, pc),
             "cpu_fused_vs_cpu_pillar": (fp, pp),
             "card_pillar_vs_cpu_pillar": (cpu[0], pp),
             "card_fused_vs_cpu_fused": (cpu[1], fp),
             "card_fused_vs_cpu_pillar": (cpu[1], pp),
             "card_pillar_vs_cpu_fused": (cpu[0], fp)}
    out = {"loss": {"card_pillar": lpc, "card_fused": lfc,
                    "cpu_pillar": lpp, "cpu_fused": lfp}}
    for name, (a, b) in pairs.items():
        share = share_of_bound(a, b)
        out[name] = {"max_share": max(share.values()),
                     "past_bound": sorted(n for n, v in share.items()
                                          if v > 1)}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--witness", type=int, nargs="*", default=[],
                    help="batches whose steps are also taken on the CPU")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    cfg = kitti_sem_config().replace(use_norm=True)
    sd = init_state_dict(cfg, seed=0)
    rng = np.random.default_rng(args.seed)
    print(json.dumps({"card": card()}), flush=True)
    for k in range(args.batches):
        points, labels = (torch.as_tensor(x, device="cuda") for x in
                          synthetic_labelled_batch(cfg, rng, 2,
                                                   cfg.num_points))
        runs = [(step(cfg, sd, points, labels, True),
                 step(cfg, sd, points, labels, False)) for _ in range(2)]
        ((p0, lp), (f0, lf)), ((p1, _), (f1, _)) = runs
        first = share_of_bound(f0, p0)
        extra = ({"witness": witness(cfg, sd, points, labels, runs[0])}
                 if k in args.witness else {})
        print(json.dumps({
            "batch": k, "loss_rel": abs(lf - lp) / abs(lp),
            "nearest_bound": sorted(first.items(), key=lambda kv: -kv[1])[:3],
            "second_pair": max(share_of_bound(f1, p1).values()),
            "repeat_max_abs": {
                "pillar": max(float((p1[n] - p0[n]).abs().max()) for n in p0),
                "fused": max(float((f1[n] - f0[n]).abs().max())
                             for n in f0)}, **extra}), flush=True)


if __name__ == "__main__":
    main()
