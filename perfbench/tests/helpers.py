"""What the benchmark's tests share: the checkout's root, BENCHMARK.json,
a checkout that holds the open-loop cell, and a tiny run of a cell in a
process of its own."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TIMEOUT_S = 600
# the open-loop cell and its end-to-end metric, which BENCHMARK.json leaves
# out until its tail can be bounded (PERF.md): its files stay, so these
# entries are all that adding it back takes
OPEN_LOOP = {"name": "kitti_sem.serve_open", "config": "kitti_sem",
             "traffic": "serve_open", "chips": 1,
             "why": "open loop: lidars at 10 Hz served one scan at a time"}
LATENCY = {"name": "latency_p95_ms", "unit": "ms", "better": "lower",
           "bound": 0.25, "source": "host_clock",
           "workloads": [OPEN_LOOP["name"]]}


def bench(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def open_loop_checkout(tmp_path) -> str:
    """A copy of the benchmark whose BENCHMARK.json adds the open-loop
    cell by its entries alone."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(os.path.join(ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    b["workloads"].append(OPEN_LOOP)
    b["end_to_end"].append(LATENCY)
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return str(root)


def tiny_run(workload: str, fault: str | None = None, root: str = ROOT):
    """(result line as a dict or None, standard error) of
    `perfbench.tests.cpu_run` on `workload` with `fault`, under `root`."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, ROOT]))
    cmd = [sys.executable, "-m", "perfbench.tests.cpu_run", root, workload]
    if fault:
        cmd.append(fault)
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                          text=True, timeout=TIMEOUT_S)
    lines = proc.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    return line, proc.stderr
