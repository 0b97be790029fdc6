"""One cell of the benchmark on the CPU at a tiny size, with a fault of
`perfbench.faults` planted or none, in a process of its own:

    python -m perfbench.tests.cpu_run <root> <workload> [fault]

prints the harness's result line.  The sizes are cut so that a run takes
seconds on one core; the traffic keeps its kind and its check.  A
configuration's cut is its entry in TINY_CONFIG, or else the rule of
`tiny_config`, so that a configuration added as files alone runs here
too."""

from __future__ import annotations

import os
import sys

TINY_CONFIG = {
    "kitti_sem": {"pc_range": [-7.0, -8.0, -4.0, 9.0, 8.0, 4.0],
                  "grid_range": [-8.0, -8.0, 8.0, 8.0], "num_points": 3000},
    "camera": {"num_points": 2000},
}
# the rule's cut: a grid wider than LARGEST_SIDE cells on a side keeps
# TINY_SIDE cells a side of its own size, and TINY_POINTS points a scan
LARGEST_SIDE = 50
TINY_SIDE = 40
TINY_POINTS = 3000
TINY_CELL = {"points": 2000, "pool": 6, "sample": 3, "warm": 1,
             "sensors": 1, "burst": 4}
TRAIN_CELL = {"points": 2000, "pool": 6}
SECONDS = 0.5


def tiny_config(name: str, raw: dict) -> dict:
    """The overrides that cut configuration `name`, whose file holds
    `raw`, to a CPU size: its TINY_CONFIG entry where it has one; else,
    for a grid wider than LARGEST_SIDE cells on a side, x and y cut to
    TINY_SIDE cells of its own voxel size about the centre of its
    pc_range, grid_range moved with pc_range (their offset kept) and
    TINY_POINTS points; z and every other key as they are.  A smaller
    grid keeps its size."""
    if name in TINY_CONFIG:
        return TINY_CONFIG[name]
    pc, grid, voxel = raw["pc_range"], raw["grid_range"], raw["voxel_size"]
    if all(round((pc[3 + k] - pc[k]) / voxel[k]) <= LARGEST_SIDE
           for k in (0, 1)):
        return {}
    pc_cut, grid_cut = list(pc), list(grid)
    for k in (0, 1):
        centre, half = (pc[k] + pc[3 + k]) / 2, TINY_SIDE * voxel[k] / 2
        pc_cut[k], pc_cut[3 + k] = centre - half, centre + half
        grid_cut[k] = grid[k] + pc_cut[k] - pc[k]
        grid_cut[2 + k] = grid[2 + k] + pc_cut[3 + k] - pc[3 + k]
    return {"pc_range": pc_cut, "grid_range": grid_cut,
            "num_points": TINY_POINTS}


def main(argv) -> int:
    root, workload = argv[0], argv[1]
    fault = argv[2] if len(argv) > 2 else None
    sys.path.insert(0, root)
    import torch

    from perfbench import cfg as cfgmod, control

    torch.set_num_threads(2)
    bench = cfgmod.read_json(os.path.join(root, "BENCHMARK.json"))
    config = next(w["config"] for w in bench["workloads"]
                  if w["name"] == workload)
    raw = cfgmod.read_json(os.path.join(root, "perfbench", "configs",
                                        config + ".json"))
    traffic = cfgmod.load_cell(workload, os.path.join(root, "perfbench"))
    cell = TINY_CELL
    if traffic["driver"] == "train_loader":
        # enough scans for the checked steps' distinct batches
        cell = {**TRAIN_CELL, "pool": max(
            TRAIN_CELL["pool"], traffic["batch"] * traffic["checked_steps"])}
    try:
        line = control.reading(workload, 4_000_000_011, SECONDS, fault,
                               device="cpu", root=root,
                               overrides={"config": tiny_config(config, raw),
                                          "cell": cell})
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 1
    import json

    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
