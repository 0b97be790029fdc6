"""The plain reference against itself, per configuration: on the card
against the CPU at B=1, and on the card a batch of 16 scans against the
same scans one at a time.  It shows how far a map moves with the order of
float32 sums alone (SegNet's argmax pools turn a near tie into a moved
activation), which is why `correct` compares the maps by percentiles.

    python3 -m perfbench.witness

One JSON line a configuration: for each pair, the largest gap, the 99th
percentile gap (both over the map's largest magnitude) and the cells that
moved by more than 1e-4 of it."""

from __future__ import annotations

import json

import numpy as np
import torch

from perfbench import cfg as cfgmod
from perfbench import reference, scenes, weights


def gaps(a: torch.Tensor, b: torch.Tensor) -> dict:
    gap = (a - b).abs().double()
    scale = float(b.abs().max())
    return {"max": float(gap.max()) / scale,
            "p99": float(torch.quantile(gap.flatten(), 0.99)) / scale,
            "cells_over_1e-4": int((gap > 1e-4 * scale).sum())}


def main() -> None:
    for name in ("kitti_sem", "camera"):
        cfg, _ = cfgmod.load_config(name)
        rng = np.random.default_rng(99)
        pts = torch.from_numpy(np.stack([
            scenes.scene(cfg.scene, cfg, rng, cfg.num_points)
            for _ in range(16)]))
        w = weights.make(cfg, 99, "cuda")
        with torch.no_grad():
            card = reference.elevation(cfg, w, pts[:1].cuda())[0].cpu()
            cpu = reference.elevation(
                cfg, {k: v.cpu() for k, v in w.items()}, pts[:1])[0]
            batch = reference.elevation(cfg, w, pts.cuda()).cpu()
            single = torch.cat([reference.elevation(cfg, w, p[None].cuda())
                                for p in pts]).cpu()
        worst = max((gaps(batch[i], single[i]) for i in range(16)),
                    key=lambda g: g["max"])
        print(json.dumps({"config": name, "card_vs_cpu": gaps(card, cpu),
                          "batch16_vs_single_worst": worst}), flush=True)


if __name__ == "__main__":
    main()
