"""One cell of the benchmark on the CPU at a tiny size, with a fault of
`perfbench.faults` planted or none, in a process of its own:

    python -m perfbench.tests.cpu_run <root> <workload> [fault]

prints the harness's result line.  The sizes are cut so that a run takes
seconds on one core; the traffic keeps its kind and its check."""

from __future__ import annotations

import sys

TINY_CONFIG = {
    "kitti_sem": {"pc_range": [-7.0, -8.0, -4.0, 9.0, 8.0, 4.0],
                  "grid_range": [-8.0, -8.0, 8.0, 8.0], "num_points": 3000},
    "camera": {"num_points": 2000},
}
TINY_CELL = {"points": 2000, "pool": 6, "sample": 3, "warm": 1,
             "sensors": 1, "burst": 4}
TRAIN_CELL = {"points": 2000, "pool": 6}
SECONDS = 0.5


def main(argv) -> int:
    root, workload = argv[0], argv[1]
    fault = argv[2] if len(argv) > 2 else None
    sys.path.insert(0, root)
    import torch

    from perfbench import control

    torch.set_num_threads(2)
    config = workload.split(".")[0]
    cell = TRAIN_CELL if "train" in workload else TINY_CELL
    try:
        line = control.reading(workload, 4_000_000_011, SECONDS, fault,
                               device="cpu", root=root,
                               overrides={"config": TINY_CONFIG.get(config,
                                                                    {}),
                                          "cell": cell})
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 1
    import json

    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
