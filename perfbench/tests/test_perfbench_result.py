"""The result a run prints: its last line's keys and its checks, the
readers of the device trace on a trace made by hand, and the control and
every fault a cell can have coming out as not correct."""

from __future__ import annotations

import os

import numpy as np
import pytest

from perfbench import cfg as cfgmod
from perfbench import tracing, yardstick
from perfbench.readers import device, host
from perfbench.tests.helpers import (OPEN_LOOP, ROOT, bench,
                                     open_loop_checkout, tiny_run)
from perfbench.traffic import Run

CELLS = [w["name"] for w in bench()["workloads"]] + [OPEN_LOOP["name"]]


def _root(workload: str, tmp_path) -> str:
    return (open_loop_checkout(tmp_path) if workload == OPEN_LOOP["name"]
            else ROOT)


@pytest.mark.parametrize("workload", CELLS)
def test_last_line(workload, tmp_path):
    root = _root(workload, tmp_path)
    line, err = tiny_run(workload, root=root)
    assert line is not None, err[-3000:]
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "readings", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    b = bench(root)
    want = {m["name"] for m in b["end_to_end"]
            if workload in m.get("workloads", [workload])}
    assert set(line["metrics"]) == want
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert line["device"]["platform"] == "cpu"
    checks = [ln for ln in err.strip().splitlines() if ln.startswith("check ")]
    assert [c.split()[1] for c in checks] == list(line["checks"])
    assert all(" limit " in c for c in checks)


# the control and the faults a cell can have, by its traffic file's driver
FAULTS = {
    "open_loop": ["control", "altered_answer"],
    "closed_pipelined": ["control", "altered_answer"],
    "closed_burst": ["control", "altered_answer", "half_burst"],
    "train_loader": ["control", "unchanged_state", "half_batch",
                     "altered_loss"],
}


def _driver(workload: str) -> str:
    return cfgmod.load_cell(workload, os.path.join(ROOT, "perfbench"))[
        "driver"]


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in CELLS for f in FAULTS[_driver(w)]])
def test_control_and_faults_are_not_correct(workload, fault, tmp_path):
    line, err = tiny_run(workload, fault, root=_root(workload, tmp_path))
    assert line is not None, err[-3000:]
    assert line["correct"] is False, line["checks"]


def _trace():
    t = tracing.Trace(enabled=False)
    t.t_start, t.t_stop = 10.0, 10.01        # a 10 ms window
    ms = 1_000_000
    t.device = [(0, 2 * ms, "radix_kernel<I32>"), (1 * ms, 3 * ms, "conv"),
                (5 * ms, 6 * ms, "hist_cluster"), (9 * ms, 10 * ms, "conv")]
    t.host = [(0, 10 * ms, "perfbench.engine.infer"),
              (3 * ms, 5 * ms, "aten::copy_"), (6 * ms, 9 * ms, "fetch")]
    return t


def test_trace_busy_and_gaps():
    t = _trace()
    assert t.busy_intervals().tolist() == [[0, 3_000_000],
                                           [5_000_000, 6_000_000],
                                           [9_000_000, 10_000_000]]
    assert t.busy_s == pytest.approx(0.005)
    assert t.idle_gaps() == [["fetch", 0.003], ["aten::copy_", 0.002]]
    assert t.device_ops()[0] == ["conv", 0.003]


def test_device_readers():
    run = Run()
    run.platform, run.trace = "gpu", _trace()
    run.done = [10.002, 10.005, 10.5]           # two inside the window
    run.units, run.window_s, run.flops_per_unit = 3, 1.5, 67e9
    run.shape = {"batch": 2, "padded": 1000, "cells": 100, "kept": 500,
                 "occupied": 50, "features": 4, "width": 64,
                 "out_bytes": 4}
    assert device.per_unit_ms(run, "unit") == pytest.approx(2.5)
    assert device.per_unit_ms(run, "call") == pytest.approx(5.0)
    assert device.idle_pct(run) == pytest.approx(50.0)
    assert device.mfu_pct(run) == pytest.approx(100 * 3 * 67e9 / 1.5 / 67e12)
    share = device.kernels_roofline(run, {"K1": "radix_kernel<[^>]*I32>",
                                          "K3": "hist_cluster"})
    least = sum(yardstick.least_seconds(*yardstick.kernel_work(k, run.shape))
                for k in ("K1", "K3"))
    assert share == pytest.approx(100 * least / 0.003)
    run.platform = "cpu"
    assert device.mfu_pct(run) is None and device.idle_pct(run) is None


# K10 as torch.profiler names it on the card (PERF.md section 7)
K10_NAME = ("void (anonymous namespace)::radix_kernel<(anonymous namespace)"
            "::Pair>(int const*, int const*, int*, int*, int, unsigned int)")


def test_k10_roofline_reads_the_pair_sort():
    """K10's share is its calls' least time over their device time, and
    K1's pattern does not take the pair sort for the key sort."""
    t = tracing.Trace(enabled=False)
    t.t_start, t.t_stop = 10.0, 10.01
    t.device = [(0, 40_000, K10_NAME), (50_000, 90_000, "hist_cluster")]
    run = Run()
    run.platform, run.trace = "gpu", t
    run.shape = {"batch": 1, "padded": 102_400, "cells": 62_500,
                 "kept": 60_000, "occupied": 9_000, "features": 4,
                 "width": 64, "out_bytes": 4}
    k1 = cfgmod.read_json(os.path.join(
        ROOT, "perfbench", "metrics", "kernels_roofline.serve.json"))[
            "kernels"]["K1"]
    least = yardstick.least_seconds(*yardstick.kernel_work("K10", run.shape))
    assert least == pytest.approx(16 * 102_400 / yardstick.HBM_BYTES_PER_S)
    share = device.kernels_roofline(run, {"K10": "radix_kernel<[^>]*Pair>"})
    assert share == pytest.approx(100 * least / 40e-6)
    assert device.kernels_roofline(run, {"K1": k1}) is None


def test_kernel_work_keeps_the_parents_values():
    """Adding K10 moved no other kernel's bytes or operations."""
    shape = {"batch": 2, "padded": 1000, "cells": 100, "kept": 500,
             "occupied": 50, "features": 4, "width": 64, "out_bytes": 4}
    parent = {"K1": (16000, 0), "K2": (73024, 515000), "K3": (9600, 2000),
              "K4": (124224, 515000), "K6": (53024, 51200)}
    assert {k: yardstick.kernel_work(k, shape) for k in parent} == parent


def test_host_readers():
    run = Run()
    run.records["latency_ms"] = list(np.arange(1.0, 101.0))
    run.units, run.window_s, run.setup_s = 50, 2.0, 7.5
    assert host.percentile(run, "latency_ms", 95) == pytest.approx(95.05)
    assert host.rate(run) == 25.0 and host.setup(run) == 7.5
    assert host.mean(run, "queue_wait_ms") is None


def test_the_run_leaves_the_host_runtime_as_it_was():
    """The harness measures the program with its own host settings: it
    sets no thread count and freezes no objects out of the collector."""
    import gc

    import torch

    from perfbench import control
    from perfbench.tests import cpu_run

    threads, frozen = torch.get_num_threads(), gc.get_freeze_count()
    line = control.reading(
        "camera.serve_closed", 4_000_000_013, cpu_run.SECONDS, None,
        device="cpu", overrides={"config": cpu_run.TINY_CONFIG["camera"],
                                 "cell": cpu_run.TINY_CELL})
    assert line["correct"] is True
    assert torch.get_num_threads() == threads
    assert gc.get_freeze_count() == frozen
