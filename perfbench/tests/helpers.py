"""What the benchmark's tests share: the checkout's root, BENCHMARK.json,
checkouts that hold the open-loop cell or a configuration added as files
alone, and a tiny run of a cell in a process of its own."""

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
# a configuration added as files and entries alone: `configs/fine_grid.yaml`
# as run, served as camera's closed loop is, under a name that no
# configuration of the benchmark takes, so that the fine grid itself can
# join later as files alone.  Its `source` and `reduced` only satisfy the
# layout checks; they are not the fine grid's.
PROBE = {"name": "files_only_probe",
         "source": "https://github.com/anshulpaigwar/GndNet/blob/"
                   "master/config/config_kittiSem.yaml",
         "file": "perfbench/configs/files_only_probe.json",
         "reduced": ["fused_impl"],
         "why": "configs/fine_grid.yaml: 250x250 cells of 0.4 m, the "
                "(cell, index) key overflows 31 bits, so K10 sorts pairs"}
PROBE_YAML = "fine_grid"
PROBE_CELL = {"name": "files_only_probe.serve_closed",
              "config": "files_only_probe", "traffic": "serve_closed",
              "chips": 1,
              "why": "closed loop: infer_pipelined, depth 3, over 64 "
                     "distinct 100 000-point scans on the fine grid"}


def bench(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def copy_checkout(tmp_path):
    """A copy of the benchmark's files under `tmp_path`, without its
    BENCHMARK.json."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(os.path.join(ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root


def open_loop_checkout(tmp_path) -> str:
    """A copy of the benchmark whose BENCHMARK.json adds the open-loop
    cell by its entries alone."""
    root = copy_checkout(tmp_path)
    b = bench()
    b["workloads"].append(OPEN_LOOP)
    b["end_to_end"].append(LATENCY)
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return str(root)


def add_probe(root: str) -> None:
    """Write into the checkout at `root` the configuration PROBE
    (`configs/<PROBE_YAML>.yaml`'s keys as run, its augmentation and data
    groups left out, `fused_impl` affine, scene `kitti`), the cell
    PROBE_CELL (camera's traffic file with 100 000 points a scan), and
    their entries in its BENCHMARK.json, in place of any it holds under
    those names: the cell joins every metric camera's cell reports."""
    import yaml

    with open(os.path.join(ROOT, "configs", PROBE_YAML + ".yaml")) as f:
        shipped = yaml.safe_load(f)
    raw = {"name": PROBE["name"], "source": PROBE["source"],
           "deployment": "one HDL-64 sweep of 100 000 points on a 100 m x "
                         "100 m grid of 0.4 m cells around the car",
           "changed": {"fused_impl": [shipped["fused_impl"], "affine"]},
           "scene": "kitti"}
    raw.update((k, v) for k, v in shipped.items()
               if k not in ("augmentation", "data_prep"))
    raw["fused_impl"] = "affine"
    here = os.path.join(root, "perfbench")
    with open(os.path.join(root, PROBE["file"]), "w") as f:
        json.dump(raw, f, indent=1)
    with open(os.path.join(here, "cells", "camera.serve_closed.json")) as f:
        cell = json.load(f)
    cell["points"] = 100_000
    with open(os.path.join(here, "cells",
                           PROBE_CELL["name"] + ".json"), "w") as f:
        json.dump(cell, f, indent=1)
    b = bench(root)
    b["configs"] = [c for c in b["configs"] if c["name"] != PROBE["name"]]
    b["configs"].append(PROBE)
    b["workloads"] = [w for w in b["workloads"]
                      if w["name"] != PROBE_CELL["name"]]
    b["workloads"].append(PROBE_CELL)
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"]
                              if w != PROBE_CELL["name"]]
        if "camera.serve_closed" in m.get("workloads", []):
            m["workloads"].append(PROBE_CELL["name"])
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f, indent=1)


def probe_checkout(tmp_path) -> str:
    """A copy of the benchmark with `add_probe`'s files and entries."""
    root = copy_checkout(tmp_path)
    (root / "BENCHMARK.json").write_text(json.dumps(bench()))
    add_probe(str(root))
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
