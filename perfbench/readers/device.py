"""Readers of the device trace of a `--trace 1` run on the card.  None
where the run had no card or no traced window."""

from __future__ import annotations

import re

from perfbench import yardstick


def _traced(run) -> bool:
    return run.platform == "gpu" and run.trace.window_s is not None


def _units_traced(run) -> int:
    t = run.trace
    return sum(1 for d in run.done if t.t_start <= d <= t.t_stop)


def per_unit_ms(run, per: str):
    """Device-busy milliseconds (the union of device operations) of the
    traced window, per unit completed in it (`per` 'unit'), or per call
    of `batch` units ('call')."""
    if not _traced(run):
        return None
    units = _units_traced(run)
    scale = run.shape["batch"] if per == "call" else 1
    return run.trace.busy_s * 1e3 * scale / units if units else None


def idle_pct(run):
    """The share of the traced window in which no device operation ran."""
    if not _traced(run):
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def mfu_pct(run):
    """Model FLOPs of the units completed in the measured window, over the
    window, over the card's float32 peak."""
    if run.platform != "gpu" or not run.units:
        return None
    return (100.0 * run.units * run.flops_per_unit / run.window_s
            / yardstick.F32_FLOPS)


def kernels_roofline(run, kernels: dict):
    """The least time of the calls of the hand-written kernels that
    `kernels` names ({kernel: profiler-name pattern}), each call's from its
    shapes, over their summed device time in the traced window."""
    if not _traced(run):
        return None
    patterns = {k: re.compile(p) for k, p in kernels.items()}
    least = device = 0.0
    for name, seconds in run.trace.kernels():
        for k, pat in patterns.items():
            if pat.search(name):
                least += yardstick.least_seconds(
                    *yardstick.kernel_work(k, run.shape))
                device += seconds
                break
    return 100.0 * least / device if device else None
