"""Profiling and timing utilities.

Counterpart of `gndnet_tpu.utils.profiling` (the reference's manual
wall-clock instrumentation: AverageMeter timers and time.time() deltas,
reference: training.py:112-123, ros_node.py:109-123,
utils/speed_test.py:6-12):

* `span` - a named host span of the program (`gndnet.<layer>.<stage>`)
  in whatever `torch.profiler` session is collecting, on the clock of
  its device trace; nothing without one;
* `trace` - a context manager around `torch.profiler` (CPU and, where
  there is a card, CUDA activities) writing a trace that TensorBoard and
  Perfetto load;
* `measure_hz` - throughput with forced completion: each rep ends on a
  host-fetched scalar that depends on every output, after
  `torch.cuda.synchronize()` on the card, and the fastest rep is kept.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name: str):
    """`with span('gndnet.engine.fetch'): ...` records the block as
    `name` while a profiler collects (`trace`, or any `torch.profiler`
    session), in the same trace as its CUDA activity.  Otherwise it
    returns one shared null context: a `record_function` costs about as
    much with no profiler as with one, so the check comes first.  Spans
    mark stage boundaries, never a loop over points."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return record_function(name)


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
