"""The benchmark of gndnet_tpu_torch on one NVIDIA H100.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout.  It reads the cell from BENCHMARK.json,
its configuration from `perfbench/configs/<config>.json`, its traffic from
`perfbench/cells/<cell>.json` and each of its metrics from
`perfbench/metrics/<metric>.json`; makes the weights and the scenes from
the seed; sets up and warms the program (every kernel built, the cell's
CUDA graphs captured), measures for `--seconds`, and then holds what the
timed path produced against the plain reference (`reference.py`).  It
prints each number compared beside its limit on standard error, and as
the last line of standard output one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1`
its per-layer metrics, read from the device trace of the window's last
seconds), `device`, with `--trace 1` `breakdown`, and `checks`.

Kernel builds, the serving artifacts and any compiler cache go to
`.perfbench_cache/` in the checkout, so only a checkout's first run
builds.  It exits non-zero, printing no result, without a card (or with
fewer than the cell's chips), without the program, and where JAX or the
JAX package was loaded by the time the window closed.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = ".perfbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gndnet_tpu", "bench")


def parse(argv):
    p = argparse.ArgumentParser(prog="perfbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The entries of BENCHMARK.json's `kind` list that the cell reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def read_metric(root: str, name: str, run):
    spec = dict(json.load(open(os.path.join(root, "perfbench", "metrics",
                                            name + ".json"))))
    module, fn = spec.pop("reader").rsplit(".", 1)
    reader = getattr(importlib.import_module("perfbench.readers." + module),
                     fn)
    return reader(run, **spec)


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def finite(x):
    return x if x is None or math.isfinite(x) else None


def fail(msg: str, code: int = 2) -> int:
    print(f"perfbench: {msg}", file=sys.stderr)
    return code


def main(argv=None, *, device=None, root: str = ROOT, overrides=None,
         patch=None) -> int:
    """Run one cell.  `device`, `overrides` ({'config': {...}, 'cell':
    {...}}) and `patch` (called once the program is imported) are for the
    tests and the control runs: `device='cpu'` skips the look for a card
    and runs the plain versions of the kernels."""
    args = parse(argv)
    overrides = overrides or {}
    cache = os.path.join(root, CACHE)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)
    from perfbench import cfg as cfgmod, tracing, traffic, yardstick

    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        return fail(f"no workload {args.workload!r} in BENCHMARK.json")
    here = os.path.join(root, "perfbench")
    cfg, keys = cfgmod.load_config(entry["config"], here,
                                   overrides.get("config"))
    cell = cfgmod.load_cell(args.workload, here, overrides.get("cell"))

    import torch

    if device is None:
        if not torch.cuda.is_available():
            return fail("no CUDA device")
        if torch.cuda.device_count() < entry["chips"]:
            return fail(f"{torch.cuda.device_count()} CUDA devices, the "
                        f"cell needs {entry['chips']}")
        device = "cuda"
    device = torch.device(device)
    try:
        from gndnet_tpu_torch import infer, train
        from gndnet_tpu_torch.config import GndNetConfig
        from gndnet_tpu_torch.utils.compile_cache import \
            enable_compilation_cache
    except ImportError as e:
        return fail(f"the program gndnet_tpu_torch does not import: {e}")
    if patch is not None:
        patch()
    enable_compilation_cache(os.path.join(cache, "kernels"))

    def cache_path(*parts):
        path = os.path.join(cache, *parts)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        return path

    ctx = SimpleNamespace(
        name=args.workload, seed=args.seed, device=device, cfg=cfg,
        cell=cell, program=SimpleNamespace(infer=infer, train=train),
        program_cfg=GndNetConfig.from_dict(keys), cache=cache_path)
    driver = traffic.DRIVERS[cell["driver"]](ctx)
    driver.setup()
    trace = tracing.Trace(args.trace == 1 and device.type == "cuda")
    trace.warm(lambda: torch.ones(1, device=device).sum().item())
    if device.type == "cuda":
        torch.cuda.synchronize()
    gc.collect()
    setup_s = time.perf_counter() - T_PROCESS
    run = driver.window(args.seconds, trace)
    run.setup_s = setup_s
    bad = loaded_forbidden()
    if bad:
        return fail("loaded in the measuring process: " + ", ".join(bad), 3)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    driver.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = driver.check()
    limits = cell["limits"]
    compared = {k: checks[k] for k in limits}
    correct = run.failed == 0 and all(
        math.isfinite(v) and v <= limits[k] for k, v in compared.items())

    run.platform = "gpu" if device.type == "cuda" else "cpu"
    run.trace = trace
    points = cell["points"]
    training = cell["driver"] == "train_loader"
    run.flops_per_unit = (yardstick.train_flops if training
                          else yardstick.forward_flops)(cfg, points)
    kind = "per_layer" if args.trace else "end_to_end"
    wanted = cell_metrics(bench, args.workload, kind)
    if args.trace:
        counts = [yardstick.scan_cells(cfg, s) for s in driver.scans()]
        run.shape = {
            "batch": cell.get("burst", cell.get("batch", 1)),
            "padded": driver.padded, "cells": cfg.num_cells,
            "kept": sum(k for k, _ in counts) / len(counts),
            "occupied": sum(o for _, o in counts) / len(counts),
            "features": cfg.input_features, "width": cfg.vfe_filters[-1],
            "out_bytes": 2 if cfg.compute_dtype == "bfloat16" else 4}
    metrics = {}
    for m in wanted:
        value = read_metric(root, m["name"], run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": run.platform,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": entry["chips"] if device.type == "cuda" else 0,
           "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        dev["power_limit"] = power_limit()
    if trace.window_s is not None:
        dev["busy_s"] = trace.busy_s
        dev["window_s"] = trace.window_s
    out = {"correct": bool(correct), "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": dev}
    if trace.window_s is not None:
        out["breakdown"] = {"device_ops": trace.device_ops(),
                            "idle_gaps": trace.idle_gaps()}
    out["readings"] = {k: finite(v) for k, v in checks.items()}
    out["checks"] = {k: {"value": finite(v), "limit": limits[k]}
                     for k, v in compared.items()}
    for k, v in compared.items():
        print(f"check {k} {v!r} limit {limits[k]!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
