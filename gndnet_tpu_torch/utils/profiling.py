"""Profiling and timing utilities.

Counterpart of `gndnet_tpu.utils.profiling` (the reference's manual
wall-clock instrumentation: AverageMeter timers and time.time() deltas,
reference: training.py:112-123, ros_node.py:109-123,
utils/speed_test.py:6-12):

* `trace` - a context manager around `torch.profiler` (CPU and, where
  there is a card, CUDA activities) writing a trace that TensorBoard and
  Perfetto load;
* `measure_hz` - throughput with forced completion: each rep ends on a
  host-fetched scalar that depends on every output, after
  `torch.cuda.synchronize()` on the card, and the fastest rep is kept;
* `StageTimer` - named accumulating host-side stage timers.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """`with trace('/tmp/tb'): step(...)` writes `<log_dir>/trace_<pid>.json`
    (Chrome trace format) with the CPU ops and, on a host with a card,
    the CUDA kernels the block ran."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}.json"))


def _anchor(out) -> float:
    """A host scalar that depends on every tensor of `out` (a tensor or a
    nested tuple / list / dict of them)."""
    if isinstance(out, torch.Tensor):
        return float(out.detach().float().sum())
    if isinstance(out, dict):
        out = list(out.values())
    return sum(_anchor(x) for x in out)


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def measure_hz(fn, make_inputs, *, units_per_call: int = 1, reps: int = 5):
    """Throughput of `fn(*make_inputs())` in units/sec with forced
    completion.

    A scalar reduction of every output is fetched to the host to end each
    rep.  Fresh inputs per rep defeat result caching; the fastest rep is
    reported (contention only adds noise upward)."""
    _anchor(fn(*make_inputs()))       # warm: builds and first launches
    best = float("inf")
    for _ in range(reps):
        args = make_inputs()
        _sync()
        t0 = time.perf_counter()
        _anchor(fn(*args))
        _sync()
        best = min(best, time.perf_counter() - t0)
    return units_per_call / best


class StageTimer:
    """Named accumulating host timers: `with t('voxelize'): ...`;
    `t.report()`."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            lines.append(
                f"{name}: total {self.totals[name]*1e3:.1f} ms over {n} "
                f"({self.totals[name]/n*1e3:.2f} ms avg)")
        return "\n".join(lines)
