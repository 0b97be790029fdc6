"""Whether the use_norm train step repeats itself on the card, and how far
the fused step lands from the pillar-path step (chip_smoke's phase-25
invariant, after tests/test_train.py:196-215).

    python -m gndnet_tpu_torch.profile_use_norm [--seed 7] [--batches 6]

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
    its two steps.
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


def step(cfg, sd, points, labels, pillar: bool):
    state = train.create_train_state(cfg, 100, state_dict=sd, device="cuda")
    state, loss = train.make_train_step(cfg, use_pillar_path=pillar)(
        state, points, labels)
    return ({k: v.detach().clone()
             for k, v in state.model.named_parameters()}, float(loss))


def share_of_bound(fused: dict, pillar: dict) -> dict:
    return {n: float(((fused[n] - pillar[n]).abs()
                      / (ATOL + RTOL * pillar[n].abs())).max())
            for n in pillar}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--batches", type=int, default=6)
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
        print(json.dumps({
            "batch": k, "loss_rel": abs(lf - lp) / abs(lp),
            "nearest_bound": sorted(first.items(), key=lambda kv: -kv[1])[:3],
            "second_pair": max(share_of_bound(f1, p1).values()),
            "repeat_max_abs": {
                "pillar": max(float((p1[n] - p0[n]).abs().max()) for n in p0),
                "fused": max(float((f1[n] - f0[n]).abs().max())
                             for n in f0)}}), flush=True)


if __name__ == "__main__":
    main()
