"""The knee of an open-loop cell: its traffic at several sensor counts,
each a whole run in this process, reporting the offered rate, the 50th
and 95th percentile latency and the queue wait of each half of the
window (a wait that grows from the first half to the second is a backlog
that grows).  The knee is the highest offered rate whose 95th percentile
stays under one sensor period with no growing backlog; the cell runs at
about four fifths of it (PERF.md).

    python3 -m perfbench.sweep --workload <cell> --sensors 20,30,40 \
        [--seconds 6] [--seed 7]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys

import numpy as np

from perfbench import run, traffic


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="perfbench.sweep")
    p.add_argument("--workload", required=True)
    p.add_argument("--sensors", required=True)
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    seen = []
    window = traffic.OpenLoop.window

    def recorded(self, seconds, trace):
        r = window(self, seconds, trace)
        seen.append((self.cell, r))
        return r

    traffic.OpenLoop.window = recorded
    for s in (int(x) for x in args.sensors.split(",")):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = run.main(["--workload", args.workload, "--seed",
                           str(args.seed), "--seconds", str(args.seconds),
                           "--trace", "0"],
                          overrides={"cell": {"sensors": s}})
        cell, r = seen[-1]
        lat = np.array(r.records["latency_ms"])
        wait = np.array(r.records["queue_wait_ms"])
        half = len(wait) // 2
        print(json.dumps({
            "sensors": s, "rc": rc,
            "offered_per_s": s / cell["period_s"],
            "served_per_s": r.units / r.window_s,
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "wait_first_half_ms": float(wait[:half].mean()),
            "wait_second_half_ms": float(wait[half:].mean()),
            "engine_call_ms": float(np.mean(r.records["engine_call_ms"])),
            "failed": r.failed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
