"""The bench's spread: each case of `python -m gndnet_tpu_torch.bench` run
as its own process, the cases in turns, `--rounds` times, then each case's
min / median / max.

    python -m gndnet_tpu_torch.bench_turns [--rounds 3] [--only CASE ...]
        [--out chiprun_out/bench_turns.jsonl] [-- <flags for every run>]

Prints every bench line as it comes (with `case` and `round` added), then
one summary line a case: the `value` of each round, and their min,
median and max, and the same of the eager engine's value where the line
has one.  A run that fails or prints no line fails the script.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (case, bench flags): every mode at kitti_sem's serving settings, the
# e2e loop also as an infer_many burst of 16, training at B=16 and B=2
CASES = (
    ("device", ["--mode", "device"]),
    ("single", ["--mode", "single"]),
    ("e2e", ["--mode", "e2e"]),
    ("e2e_burst16", ["--mode", "e2e", "--burst", "16"]),
    ("batched_B16", ["--mode", "batched", "--batch", "16"]),
    ("train_B16", ["--mode", "train", "--batch", "16"]),
    ("train_B2", ["--mode", "train", "--batch", "2"]),
    ("replay", ["--mode", "replay"]),
    ("stream", ["--mode", "stream"]),
)
RUN_TIMEOUT_S = 900


def spread(values: list) -> dict:
    """min, median and max of `values`."""
    ordered = sorted(values)
    mid = len(ordered) // 2
    median = (ordered[mid] if len(ordered) % 2
              else (ordered[mid - 1] + ordered[mid]) / 2)
    return {"min": ordered[0], "median": median, "max": ordered[-1]}


def summarize(lines: list) -> list:
    """One line a case from the bench lines of every round."""
    out = []
    for case in dict.fromkeys(line["case"] for line in lines):
        mine = [line for line in lines if line["case"] == case]
        row = {"case": case, "rounds": len(mine),
               "device": mine[0]["device"], "unit": mine[0]["unit"],
               "values": [line["value"] for line in mine],
               **spread([line["value"] for line in mine])}
        if all("eager" in line for line in mine):
            eager = [line["eager"]["value"] for line in mine]
            row["eager"] = {"values": eager, **spread(eager)}
        out.append(row)
    return out


def run_case(case: str, flags: list, extra: list) -> dict:
    cmd = [sys.executable, "-m", "gndnet_tpu_torch.bench", *flags, *extra]
    done = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=RUN_TIMEOUT_S)
    lines = [x for x in done.stdout.splitlines() if x.startswith("{")]
    if done.returncode != 0 or len(lines) != 1:
        raise RuntimeError(f"{case}: exit {done.returncode}, "
                           f"{len(lines)} lines\n{done.stderr[-3000:]}")
    return json.loads(lines[0])


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(prog="python -m gndnet_tpu_torch."
                                      "bench_turns")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None, help="also write every line here")
    ap.add_argument("--only", action="append", default=[],
                    help="run this case only (repeatable; default: all)")
    ap.add_argument("extra", nargs="*",
                    help="flags for every bench run, after --")
    args = ap.parse_args(argv)
    cases = [(c, f) for c, f in CASES if not args.only or c in args.only]
    lines = []
    for rnd in range(args.rounds):
        for case, flags in cases:
            line = {"case": case, "round": rnd,
                    **run_case(case, flags, args.extra)}
            print(json.dumps(line), flush=True)
            lines.append(line)
    summary = summarize(lines)
    for row in summary:
        print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines + summary)
    return summary


if __name__ == "__main__":
    main()
