"""Readings of the numbers `correct` compares, over many seeds in one
process: the sound program, its control or a planted fault
(`faults.py`), each seed a whole run of the cell (set-up, a short window
at the cell's own load, the check).  The limits in `cells/<cell>.json`
were set from these readings (PERF.md gives them).

    python3 -m perfbench.control --workload <cell> --seeds 1,2,3 \
        [--fault control|altered_answer|...] [--seconds 2]

One JSON line a seed: the seed, the fault, and each number compared.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys

from perfbench import faults, run


def reading(workload: str, seed: int, seconds: float, fault, device=None,
            root: str = run.ROOT, overrides=None) -> dict:
    """One run's result line, with `fault` planted."""
    cfg_over, patch = faults.apply(fault)
    over = {"config": {**(overrides or {}).get("config", {}), **cfg_over},
            "cell": (overrides or {}).get("cell", {})}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", "0"],
                      device=device, root=root, overrides=over, patch=patch)
    if rc != 0:
        raise RuntimeError(f"{workload} seed {seed} fault {fault}: rc {rc}")
    return json.loads(out.getvalue().strip().splitlines()[-1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="perfbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--fault", default=None, choices=faults.FAULTS)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = reading(args.workload, seed, args.seconds, args.fault)
        print(json.dumps({"seed": seed, "fault": args.fault or "sound",
                          "correct": res["correct"],
                          "readings": res["readings"],
                          "metrics": {k: v["value"] for k, v in
                                      res["metrics"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
